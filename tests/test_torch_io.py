"""The port's cv2-free ``io.video``, its native host runtime and ``utils``
(``stereo_vision_tpu_torch.io``, ``.native``, ``.utils``), on the CPU.

Frames are read from raw AVIs that ``cv2.VideoWriter`` writes here (``Y800``
8-bit gray and ``RGBA`` 32-bit, at widths 64 and 66: rows not a multiple of
4 bytes) and held bit for bit to the JAX package's cv2 reader; the port's
writers are read back by the JAX package. cv2 is used only by the tests.
"""

import json
import os
import stat
import subprocess
import sys
import threading
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from stereo_vision_tpu import native as jnative
from stereo_vision_tpu.io import video as jvideo
from stereo_vision_tpu.utils import filenames as jfilenames
from stereo_vision_tpu_torch import native
from stereo_vision_tpu_torch.io import loader, video
from stereo_vision_tpu_torch.utils import StageTimer, filenames, highest_precision, profiling, time_jitted, trace

ROOT = Path(__file__).resolve().parents[1]
T, H = 7, 48
FPS = 29.97
CLIPS = [(fourcc, w) for fourcc in ("Y800", "RGBA") for w in (64, 66)]
READS = [dict(), dict(start=2, interval=2, max_frames=2), dict(grayscale=True),
         dict(start=1, interval=3, grayscale=True, max_frames=None), dict(max_frames=0), dict(start=T + 1)]


def _cv2_clip(path: Path, fourcc: str, w: int, seed: int = 0, n: int = T) -> Path:
    """n random frames written by cv2 in a raw format (gray frames for
    Y800, BGR ones for RGBA)."""
    rng = np.random.default_rng(seed)
    color = fourcc == "RGBA"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), FPS, (w, H), color)
    assert vw.isOpened()
    for _ in range(n):
        vw.write(rng.integers(0, 256, (H, w, 3) if color else (H, w), dtype=np.uint8))
    vw.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    return {(f, w): _cv2_clip(d / f"{f}_{w}.avi", f, w, seed=w) for f, w in CLIPS}


@pytest.fixture
def no_ffmpeg(tmp_path, monkeypatch):
    """A PATH on which neither ffmpeg nor ffprobe is found."""
    empty = tmp_path / "empty_path"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))


@pytest.mark.parametrize("clip", CLIPS, ids=[f"{f}-{w}" for f, w in CLIPS])
@pytest.mark.parametrize("kw", READS, ids=["all", "start-interval-max", "gray", "gray-start-interval", "max0",
                                           "past-end"])
def test_iter_and_extract_frames_match_jax(clips, clip, kw):
    """iter_frames / extract_frames bit for bit, indices, dtypes and shapes
    equal to the JAX package's cv2 reader."""
    path = clips[clip]
    mine, ref = list(video.iter_frames(path, **kw)), list(jvideo.iter_frames(path, **kw))
    assert [i for i, _ in mine] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ekw = {"interval": 1, **kw}
    (fa, ia), (fb, ib) = video.extract_frames(path, **ekw), jvideo.extract_frames(path, **ekw)
    assert fa.dtype == fb.dtype and fa.shape == fb.shape and ia.dtype == ib.dtype
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ia, ib)


@pytest.mark.parametrize("clip", CLIPS, ids=[f"{f}-{w}" for f, w in CLIPS])
def test_video_info_matches_jax(clips, clip):
    """fps (from the stream header's rate / scale) and frame_count (from
    the index) as cv2 reads them."""
    assert video.video_info(clips[clip]) == jvideo.video_info(clips[clip])


def test_video_info_and_find_video_of_missing_files_match_jax(tmp_path, clips):
    missing = tmp_path / "nope.avi"
    assert video.video_info(missing) == jvideo.video_info(missing)
    d = next(iter(clips.values())).parent
    for stem in ("Y800_64", "RGBA_66", "nope"):
        assert video.find_video(d, stem) == jvideo.find_video(d, stem)
    assert video.VIDEO_EXTENSIONS == jvideo.VIDEO_EXTENSIONS
    with pytest.raises(IOError):
        list(video.iter_frames(missing))


def test_gray_rule_equals_cv2_over_every_colour():
    """The grayscale=True rule on a 4096x4096 image of all 2^24 colours
    equals cv2.cvtColor(BGR2GRAY); the frame ring's 8.8 pack does not (by
    1 on ~2.2M colours), and the port keeps each where the reference
    uses it."""
    c = np.arange(2**24, dtype=np.uint32)
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    ref = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(video._cv2_gray(rgb), ref)
    packed = native.pack_gray(rgb[None])[0]
    np.testing.assert_array_equal(packed, jnative.pack_gray(rgb[None])[0])
    assert 2_000_000 < int((packed != ref).sum()) < 2_500_000


def test_writers_read_back_by_jax(tmp_path):
    """write_video and VideoSink AVIs, read by the JAX package's cv2 reader,
    give the frames written: RGB and BGR input, gray, odd sizes (padded
    chunks), gray frames into a colour sink; fps and counts as written."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (5, 33, 35, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (4, 33, 35), dtype=np.uint8)
    p = video.write_video(tmp_path / "sub" / "rgb.avi", rgb, fps=12.5)
    np.testing.assert_array_equal(jvideo.extract_frames(p, interval=1, max_frames=9)[0], rgb)
    assert jvideo.video_info(p) == {"fps": 12.5, "frame_count": 5, "width": 35, "height": 33}
    p = video.write_video(tmp_path / "bgr.avi", rgb[..., ::-1], is_rgb=False)
    np.testing.assert_array_equal(jvideo.extract_frames(p, interval=1, max_frames=9)[0], rgb)
    p = video.write_video(tmp_path / "gray.avi", gray, fps=30)
    np.testing.assert_array_equal(jvideo.extract_frames(p, interval=1, max_frames=9, grayscale=True)[0], gray)
    np.testing.assert_array_equal(video.extract_frames(p, interval=1, max_frames=9, grayscale=True)[0], gray)
    with video.VideoSink(tmp_path / "sink.avi", fps=FPS) as sink:
        sink.append(rgb[0])
        sink.append(gray[1])
        sink.append(rgb[2])
    assert sink.frames == 3
    got = jvideo.extract_frames(tmp_path / "sink.avi", interval=1, max_frames=9)[0]
    np.testing.assert_array_equal(got, np.stack([rgb[0], np.stack([gray[1]] * 3, -1), rgb[2]]))
    assert jvideo.video_info(tmp_path / "sink.avi")["fps"] == FPS


def test_video_sink_refusals(tmp_path):
    """A frame of another size is refused (the reference's cv2 writer drops
    it silently), and so is a colour frame in a gray (Y800) sink."""
    sink = video.VideoSink(tmp_path / "s.avi")
    sink.append(np.zeros((8, 10), np.uint8))
    with pytest.raises(ValueError, match="sink shape"):
        sink.append(np.zeros((8, 12), np.uint8))
    with pytest.raises(ValueError, match="gray"):
        sink.append(np.zeros((8, 10, 3), np.uint8))
    sink.close()
    assert jvideo.video_info(tmp_path / "s.avi")["frame_count"] == 1


def test_compressed_files_without_ffmpeg_raise(tmp_path, no_ffmpeg):
    """Where ffmpeg is not found, a compressed file (.mp4, a motion-JPEG
    AVI) raises IOError naming the format and the program in every reader,
    and the writers refuse a path they cannot write; ffprobe's timestamps
    are empty, as the reference's."""
    frames = np.random.default_rng(2).integers(0, 256, (3, H, 64, 3), dtype=np.uint8)
    for name, fourcc, fmt in (("c.mp4", "mp4v", ".mp4 container"), ("m.avi", "MJPG", "b'MJPG'")):
        vw = cv2.VideoWriter(str(tmp_path / name), cv2.VideoWriter_fourcc(*fourcc), 10, (64, H))
        for f in frames:
            vw.write(f)
        vw.release()
        for call in (lambda p: list(video.iter_frames(p)), video.video_info, video.extract_frames,
                     lambda p: loader.VideoPrefetcher(p, 2)):
            with pytest.raises(IOError, match="ffmpeg") as e:
                call(tmp_path / name)
            assert fmt in str(e.value)
        assert video.extract_timestamps_ffprobe(tmp_path / name).size == 0
        assert jvideo.extract_timestamps_ffprobe(tmp_path / name).size == 0
    for name in ("out.mp4", "out.mov"):
        with pytest.raises(IOError, match="ffmpeg"):
            video.write_video(tmp_path / name, frames)
        with pytest.raises(IOError, match="ffmpeg"):
            video.VideoSink(tmp_path / name)


_STUB = '''#!{python}
"""A stand-in for {name}, decoding and encoding with cv2 (tests only)."""
import json, sys
import cv2, numpy as np
argv = sys.argv[1:]
if "{name}" == "ffprobe":
    cap = cv2.VideoCapture(argv[-1])
    if not cap.isOpened():
        sys.exit(1)
    fps = cap.get(cv2.CAP_PROP_FPS)
    print(json.dumps({{"streams": [{{"width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), "avg_frame_rate": f"{{fps}}/1",
        "nb_frames": str(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))}}], "format": {{}}}}))
elif argv[argv.index("-i") + 1] != "-":
    cap = cv2.VideoCapture(argv[argv.index("-i") + 1])
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        sys.stdout.buffer.write(np.ascontiguousarray(frame[..., ::-1]).tobytes())
else:
    w, h = map(int, argv[argv.index("-s") + 1].split("x"))
    vw = cv2.VideoWriter(argv[-1], cv2.VideoWriter_fourcc(*"mp4v"), float(argv[argv.index("-r") + 1]), (w, h))
    while True:
        buf = sys.stdin.buffer.read(w * h * 3)
        if len(buf) < w * h * 3:
            break
        vw.write(np.frombuffer(buf, np.uint8).reshape(h, w, 3)[..., ::-1].copy())
    vw.release()
'''


def test_compressed_files_through_ffmpeg(tmp_path, monkeypatch):
    """Where ffmpeg and ffprobe are on PATH, a compressed file is decoded
    through the ffmpeg pipe and written through its encoder: with stand-ins
    that decode and encode with cv2, the port's frames, indices and info
    equal the JAX package's, and an .mp4 written by the port reads back
    through the JAX package as the frames the stand-in encoded."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name in ("ffmpeg", "ffprobe"):
        p = bindir / name
        p.write_text(_STUB.format(python=sys.executable, name=name))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    frames = np.random.default_rng(3).integers(0, 256, (6, H, 64, 3), dtype=np.uint8)
    vw = cv2.VideoWriter(str(tmp_path / "c.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, H))
    for f in frames:
        vw.write(f)
    vw.release()
    for kw in (dict(), dict(start=1, interval=2, grayscale=True)):
        mine, ref = list(video.iter_frames(tmp_path / "c.mp4", **kw)), list(jvideo.iter_frames(tmp_path / "c.mp4", **kw))
        assert [i for i, _ in mine] == [i for i, _ in ref] and len(mine) > 0
        for (_, a), (_, b) in zip(mine, ref):
            np.testing.assert_array_equal(a, b)
    assert video.video_info(tmp_path / "c.mp4") == jvideo.video_info(tmp_path / "c.mp4")
    out = video.write_video(tmp_path / "w.mp4", frames, fps=10)
    assert jvideo.video_info(out)["frame_count"] == 6
    np.testing.assert_array_equal(video.extract_frames(out, interval=1)[0], jvideo.extract_frames(out, interval=1)[0])


@pytest.mark.parametrize("fourcc", ["Y800", "RGBA"])
def test_create_synchronized_videos(tmp_path, fourcc):
    """A raw AVI pair gives left_synced.avi / right_synced.avi in the
    sources' format, the frames from each start copied exactly (the JAX
    package reads them), at the source's rate or the one given."""
    left = _cv2_clip(tmp_path / "l.avi", fourcc, 66, seed=4)
    right = _cv2_clip(tmp_path / "r.avi", fourcc, 66, seed=5)
    lo, ro = video.create_synchronized_videos(left, right, 1, 3, tmp_path / "out", duration_frames=3)
    assert (lo.name, ro.name) == ("left_synced.avi", "right_synced.avi")
    for src, start, dst in ((left, 1, lo), (right, 3, ro)):
        np.testing.assert_array_equal(jvideo.extract_frames(dst, interval=1)[0],
                                      jvideo.extract_frames(src, start=start, interval=1, max_frames=3)[0])
        assert jvideo.video_info(dst)["fps"] == FPS
    lo, _ = video.create_synchronized_videos(left, right, 2, 0, tmp_path / "all", fps=50.0)
    assert video.video_info(lo) == {"fps": 50.0, "frame_count": T - 2, "width": 66, "height": H}
    with pytest.raises(IOError):  # the reference's cv2 writes empty files for a source it cannot open
        video.create_synchronized_videos(tmp_path / "nope.avi", right, 0, 0, tmp_path / "none")


def test_opendml_parts_and_unindexed_files_match_jax(tmp_path):
    """Frames past the first RIFF (an OpenDML 'AVIX' part, which writers add
    past 1 GiB and idx1 does not cover) and a file without idx1 (the 'movi'
    list walked) decode as the JAX package's cv2 reader decodes them."""
    import struct

    frames = np.random.default_rng(6).integers(0, 256, (5, 16, 21), dtype=np.uint8)
    p = video.write_video(tmp_path / "x.avi", frames[:3])
    movi = b"movi" + b"".join(b"00dc" + struct.pack("<I", f.size) + f.tobytes() + b"\0" * (f.size & 1)
                              for f in frames[3:])
    avix = b"AVIX" + b"LIST" + struct.pack("<I", len(movi)) + movi
    with open(p, "ab") as f:
        f.write(b"RIFF" + struct.pack("<I", len(avix)) + avix)
    data = p.read_bytes()
    no_idx1 = tmp_path / "no_idx1.avi"
    no_idx1.write_bytes(data[:data.index(b"idx1")])
    for path, n in ((p, 5), (no_idx1, 3)):
        mine, ref = list(video.iter_frames(path, grayscale=True)), list(jvideo.iter_frames(path, grayscale=True))
        assert [i for i, _ in mine] == [i for i, _ in ref] == list(range(n))
        for (_, a), (_, b), want in zip(mine, ref, frames):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, want)


def test_truncated_avi_raises(tmp_path):
    """A file cut inside a frame's chunk: the frames before it decode, the
    cut one raises IOError (no silent short read)."""
    p = _cv2_clip(tmp_path / "t.avi", "RGBA", 64)
    data = p.read_bytes()
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:data.rindex(b"00dc", 0, data.index(b"idx1")) + 8 + 100])
    got = []
    with pytest.raises(IOError, match="cut short"):
        for idx, _ in video.iter_frames(cut):
            got.append(idx)
    assert got == list(range(T - 1))


def test_native_pack_and_brightness_match_jax(rng, monkeypatch):
    """pack_gray and brightness_series equal the JAX package's, through the
    C++ module and through the numpy fallback."""
    assert native.native_available("host_ops") and native.native_available("frame_ring")
    rgb = rng.integers(0, 256, (3, 24, 31, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (5, 16, 17)).astype(np.uint8)
    for _ in range(2):
        np.testing.assert_array_equal(native.pack_gray(rgb), jnative.pack_gray(rgb))
        np.testing.assert_array_equal(native.brightness_series(rgb), jnative.brightness_series(rgb))
        np.testing.assert_array_equal(native.brightness_series(gray), jnative.brightness_series(gray))
        monkeypatch.setattr(native, "_native", lambda name="host_ops": None)


def test_port_modules_compile_nothing_on_import():
    """Importing io, native, utils and the streaming module builds and loads
    no native module, and the package walk (tests/test_torch_pipeline.py's
    no-JAX check) reaches io, native and utils."""
    code = (
        "import pkgutil, stereo_vision_tpu_torch as p\n"
        "import stereo_vision_tpu_torch.io.loader, stereo_vision_tpu_torch.utils\n"
        "import stereo_vision_tpu_torch.parallel.streaming\n"
        "from stereo_vision_tpu_torch import native\n"
        "assert native._mods == {}, native._mods\n"
        "names = {m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')}\n"
        "need = {'stereo_vision_tpu_torch.' + m for m in ('io', 'io.video', 'io.loader', 'native', 'native.build',\n"
        "        'utils', 'utils.filenames', 'utils.precision', 'utils.profiling')}\n"
        "assert need <= names, need - names\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("package", ["io", "utils"])
def test_exports_match_jax(package):
    """io.__all__ and utils.__all__ equal the JAX package's (read in a
    subprocess), and every name resolves."""
    code = f"import json, stereo_vision_tpu.{package} as p; print(json.dumps(p.__all__))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    mine = __import__(f"stereo_vision_tpu_torch.{package}", fromlist=["__all__"])
    assert mine.__all__ == json.loads(out.stdout.strip().splitlines()[-1])
    for name in mine.__all__:
        assert hasattr(mine, name), name


def test_extract_distance_from_filename_matches_jax():
    for name in ("ball_2000mm.png", "validate_3.5m.mp4", "dist_250cm_left.MOV", "2.5.mp4", "clip_150.mp4",
                 "x.avi", "run_12MM_b.avi", "a_3m_b_20cm.mov"):
        assert filenames.extract_distance_from_filename(name) == jfilenames.extract_distance_from_filename(name)


def test_time_jitted_chains_its_calls():
    """Each of the n timed calls (after a warm-up chain) gets an input that
    depends on the previous output and differs from the last; the caller's
    tensors are not written; an explicit perturb / reduce_out is used; all-
    bool inputs need a hook."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    keep = x.clone()
    seen = []

    def fn(a, b):
        seen.append(a.clone())
        return a * 2 + b

    s = time_jitted(fn, (x, torch.ones(3, 4)), n=3)
    assert s > 0 and len(seen) == 6
    torch.testing.assert_close(x, keep, rtol=0, atol=0)
    firsts = [float(a[0, 0]) for a in seen]
    assert len(set(firsts[3:])) == 3  # the timed calls' inputs all differ
    # call i's bump is carry + i, the carry the previous output's centre
    assert firsts[4] - firsts[3] == float((seen[3] * 2 + 1)[1, 2]) + 1
    calls = []
    time_jitted(lambda a: a + 1, (x,), n=2, perturb=lambda fl, c, i: calls.append(i) or fl,
                reduce_out=lambda out: out.sum())
    assert calls == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="perturb"):
        time_jitted(lambda m: m.sum(), (torch.ones(2, dtype=torch.bool),))


def test_stage_timer_and_trace(tmp_path):
    """StageTimer sums a stage's intervals and its pixels (Mpx/s over all
    of them); trace writes a Chrome trace that holds the traced ops."""
    t = StageTimer()
    for _ in range(2):
        with t("remap", pixels=1_000_000):
            sum(range(10000))
    with t("match"):
        pass
    m = t.metrics
    assert set(m) == {"remap_ms", "match_ms", "remap_mpx_per_s"}
    assert m["remap_mpx_per_s"] == pytest.approx(2_000_000 / m["remap_ms"] / 1e3)
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in e.key for e in prof.key_averages())


def test_span_off_records_and_allocates_nothing():
    """Without a recording, ``span`` hands out one shared object whatever it
    is given, and a recording opened afterwards holds none of those spans."""
    first = profiling.span("a", 1, "left")
    assert all(profiling.span(f"s{i}", i) is first for i in range(100))
    with first, profiling.span("b"):
        pass
    with profiling.recording() as spans:
        pass
    assert spans == []


def test_span_on_records_name_seq_thread_and_nesting():
    """Spans from two threads, each with its seq and clip and its thread's
    ident; a span entered inside another on one thread lies within it; a
    span still open when the recording ends is dropped."""
    def work(clip):
        with profiling.span("outer", 3, clip):
            with profiling.span("inner", 3, clip):
                time.sleep(0.002)

    with profiling.recording() as spans:
        t = threading.Thread(target=work, args=("right",))
        t.start()
        work("left")
        t.join()
        late = profiling.span("late")
        late.__enter__()
    late.__exit__(None, None, None)
    assert sorted((s.name, s.seq, s.clip) for s in spans) == [
        ("inner", 3, "left"), ("inner", 3, "right"), ("outer", 3, "left"), ("outer", 3, "right")]
    assert {s.thread for s in spans if s.clip == "left"} == {threading.get_ident()}
    assert {s.thread for s in spans if s.clip == "right"} == {t.ident}
    for clip in ("left", "right"):
        inner, outer = (next(s for s in spans if s.name == n and s.clip == clip) for n in ("inner", "outer"))
        assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
        assert inner.end_ns - inner.start_ns >= 2_000_000


def test_span_clock_is_the_profilers():
    """A span's start lies within 2 ms of a ``torch.profiler``
    ``record_function`` event entered on the same line: both are Unix-epoch
    nanoseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profiling.recording() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the profiler's first event can come late
            pass
        for i in range(5):
            with record_function(f"rf{i}"), profiling.span(f"rf{i}"):
                sum(range(1000))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    gaps = sorted(abs(s.start_ns - events[s.name].start_ns()) for s in spans)
    assert len(gaps) == 5 and gaps[2] < 2_000_000, gaps  # the median: one preempted span may lie further


def test_trace_writes_the_program_spans(tmp_path):
    """``trace`` records the block's spans and writes them into its Chrome
    trace, on a track of each thread, near the profiler's own events."""
    def decode():
        with profiling.span("loader.read", 0, "left"):
            time.sleep(0.001)

    with trace(str(tmp_path / "tr")):
        with profiling.span("stream.launch", 0):
            torch.ones(8).add(1)
        t = threading.Thread(target=decode, name="decode-left")
        t.start()
        t.join()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("pid") == "program spans" and e["ph"] == "X"}
    assert set(mine) == {"stream.launch", "loader.read"}
    assert mine["loader.read"]["args"] == {"seq": 0, "clip": "left"}
    assert mine["stream.launch"]["tid"] != mine["loader.read"]["tid"]
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("pid") == "program spans" and e["ph"] == "M"}
    assert names[mine["loader.read"]["tid"]] == "decode-left"
    torch_ts = [e["ts"] for e in events if e.get("ph") == "X" and e.get("pid") != "program spans"]
    assert abs(mine["stream.launch"]["ts"] - min(torch_ts)) < 1e5  # microseconds, on one clock


def test_highest_precision_turns_tf32_off_and_restores():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    seen = []

    @highest_precision
    def f(a):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return a @ a

    torch.testing.assert_close(f(torch.eye(3)), torch.eye(3))
    assert seen == [(False, False)] and f.__name__ == "f"
    assert (cudnn.allow_tf32, matmul.allow_tf32) == before
