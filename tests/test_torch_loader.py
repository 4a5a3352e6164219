"""The port's frame ring, prefetching loader and ``stream_video_pair``
(``stereo_vision_tpu_torch.io.loader``, ``.parallel.streaming``), on the CPU.

The ring's semantics run under both backends, the C++ ring and the locked
``queue.Queue`` (the ``ring_backend`` fixture, as tests/test_loader.py
runs the JAX package's). The loader and the stream are held to the JAX
package's on the same cv2-written raw AVIs: windows, seqs, ``n_valid`` and
tail padding equal; for ``bm`` and ``sgbm`` the stream's disparity exactly,
points and stats within float32 rtol 1e-6, the port on
``host_cpu_mesh(4)`` and JAX on the conftest's virtual devices. The rig is
the reference test's (``stereo_rectify`` of an undistorted rig, alpha 0,
here by the port's geometry ops).
JAX's stream jits the pipeline, and XLA's fused remap can round a pixel at
a .5 tie the other way than its eager ``batched_stereo_pipeline`` (which
the port equals), on maps whose weights are such ties; this rig's are not.
``sgbm_hier`` is held to the port's own ``batched_stereo_pipeline`` window
by window (JAX's hier in interpret mode takes about a minute a call).
"""

import gc
import queue
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from stereo_vision_tpu import native as jnative
from stereo_vision_tpu.io import loader as jloader
from stereo_vision_tpu.io import video as jvideo
from stereo_vision_tpu.parallel import create_mesh as jcreate_mesh
from stereo_vision_tpu.parallel import streaming as jstreaming
from stereo_vision_tpu.stereo.bm import StereoBMParams as JBMParams
from stereo_vision_tpu.stereo.sgbm import StereoSGBMParams as JSGBMParams
from stereo_vision_tpu_torch import convert, native, ops
from stereo_vision_tpu_torch.io.loader import FrameRing, StereoPairLoader, VideoPrefetcher
from stereo_vision_tpu_torch.parallel import streaming
from stereo_vision_tpu_torch.parallel.mesh import host_cpu_mesh
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
from stereo_vision_tpu_torch.synth.scenes import scene
from stereo_vision_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test (the plain forms are many small ops;
    several test workers otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["native", "fallback"])
def ring_backend(request, monkeypatch):
    if request.param == "native":
        assert native.frame_ring_module() is not None, "the C++ ring failed to build"
    else:
        monkeypatch.setattr(native, "frame_ring_module", lambda: None)
    return request.param


def test_ring_fifo_gray_pack_and_backend(ring_backend, rng):
    r = FrameRing(3, (2, 4, 8))
    assert (r._mod is not None) == (ring_backend == "native")
    rgb = rng.integers(0, 255, (2, 4, 8, 3)).astype(np.uint8)
    assert r.put_gray(rgb) == 0
    assert r.put(np.full((2, 4, 8), 7, np.uint8)) == 1
    seq, win = r.get()
    assert seq == 0
    np.testing.assert_array_equal(win, jnative.pack_gray(rgb))
    seq, win = r.get()
    assert seq == 1 and int(win[0, 0, 0]) == 7 and win.shape == (2, 4, 8)
    with pytest.raises(ValueError):
        r.put(np.zeros(5, np.uint8))


def test_ring_put_blocks_on_full_until_get(ring_backend):
    r = FrameRing(1, (4,))
    r.put(np.zeros(4, np.uint8))
    done = threading.Event()

    def producer():
        r.put(np.ones(4, np.uint8))
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.15)
    assert not done.is_set(), "put should block while the ring is full"
    assert r.get()[0] == 0
    assert done.wait(2.0)
    assert r.get()[0] == 1


def test_ring_timeout_close_drain_and_stats(ring_backend):
    r = FrameRing(2, (4,))
    assert r.stats() == (0, 2, False)
    with pytest.raises(queue.Empty):
        r.get(timeout=0.05)
    r.put(np.zeros(4, np.uint8))
    assert r.stats() == (1, 2, False)
    r.close()
    assert r.stats() == (1, 2, True)
    assert r.get()[0] == 0  # buffered windows survive close
    assert r.get() is None  # then drained
    with pytest.raises(RuntimeError):
        r.put(np.zeros(4, np.uint8))


def test_ring_close_wakes_every_blocked_producer(ring_backend):
    r = FrameRing(1, (8,))
    r.put(np.zeros(8, np.uint8))
    raised = []

    def blocked_producer():
        try:
            r.put(np.ones(8, np.uint8))
        except RuntimeError as e:
            raised.append(e)

    threads = [threading.Thread(target=blocked_producer, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    r.close()
    for t in threads:
        t.join(5.0)
        assert not t.is_alive(), "close must release every blocked put"
    assert len(raised) == 3
    assert r.get()[0] == 0
    assert r.get() is None


def _waits():
    return profiling.counters()


def test_ring_counts_a_consumers_wait(ring_backend):
    """A consumer blocked on an empty ring until a put 100 ms later adds at
    least 40 ms to ``ring.get_wait_ns`` and one get, on the ring and in the
    totals (the margin is for a loaded machine's scheduling); a get that
    finds a window ready adds a get and next to no wait."""
    r = FrameRing(2, (4,))
    before = _waits()
    threading.Timer(0.1, r.put, args=(np.zeros(4, np.uint8),)).start()
    assert r.get()[0] == 0
    after = _waits()
    assert after["ring.get_wait_ns"] - before["ring.get_wait_ns"] >= 40_000_000
    assert after["ring.gets"] - before["ring.gets"] >= 1  # other tests' threads may add to the totals
    assert r.waits()["get_wait_ns"] >= 40_000_000 and r.waits()["gets"] == 1
    r.put(np.zeros(4, np.uint8))
    ready = r.waits()
    assert r.get()[0] == 1
    done = r.waits()
    assert done["gets"] == 2 and done["get_wait_ns"] - ready["get_wait_ns"] < 40_000_000


def test_ring_counts_a_producers_wait(ring_backend):
    """A producer blocked on a full ring until a get adds that wait to
    ``ring.put_wait_ns``."""
    r = FrameRing(1, (4,))
    r.put(np.zeros(4, np.uint8))
    before = _waits()
    threading.Timer(0.1, r.get).start()
    r.put(np.ones(4, np.uint8))
    after = _waits()
    assert after["ring.put_wait_ns"] - before["ring.put_wait_ns"] >= 40_000_000
    assert after["ring.puts"] - before["ring.puts"] >= 1
    assert r.waits()["puts"] == 2 and r.waits()["put_wait_ns"] >= 40_000_000


def test_ring_counters_survive_the_rings_close(ring_backend):
    """The totals keep a ring's waits once it is closed and freed."""
    r = FrameRing(1, (4,))
    before = _waits()
    threading.Timer(0.1, r.put, args=(np.zeros(4, np.uint8),)).start()
    r.get()
    r.close()
    assert r.get() is None
    del r
    gc.collect()
    after = _waits()
    assert after["ring.get_wait_ns"] - before["ring.get_wait_ns"] >= 40_000_000
    assert after["ring.gets"] - before["ring.gets"] >= 2 and after["ring.puts"] - before["ring.puts"] >= 1


def test_ring_counters_names_on_both_backends(ring_backend):
    """Both backends give the same four counters, whole numbers."""
    FrameRing(1, (4,)).put(np.zeros(4, np.uint8))
    c = _waits()
    assert sorted(c) == ["ring.get_wait_ns", "ring.gets", "ring.put_wait_ns", "ring.puts"]
    assert all(isinstance(v, int) and v >= 0 for v in c.values())
    assert set(FrameRing(1, (4,)).waits()) == {"put_wait_ns", "puts", "get_wait_ns", "gets"}


@pytest.mark.parametrize("n_prod,n_cons", [(4, 1), (1, 4), (4, 3)])
def test_ring_mpmc_no_drop_no_duplicate(ring_backend, n_prod, n_cons):
    """Dense seqs and intact windows under several producers and consumers
    (100 windows a producer through 4 slots)."""
    per_prod = 100
    r = FrameRing(4, (16,))
    produced: dict[int, int] = {}
    consumed: dict[int, int] = {}
    errors: list[Exception] = []

    def producer(pid):
        try:
            rng = np.random.default_rng(pid)
            for _ in range(per_prod):
                val = int(rng.integers(0, 251))
                produced[r.put(np.full(16, val, np.uint8))] = val
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def consumer():
        try:
            while (got := r.get()) is not None:
                seq, win = got
                assert (win == win[0]).all(), "window content torn"
                consumed[seq] = int(win[0])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = ([threading.Thread(target=producer, args=(p,), daemon=True) for p in range(n_prod)]
               + [threading.Thread(target=consumer, daemon=True) for _ in range(n_cons)])
    for t in threads:
        t.start()
    for t in threads[:n_prod]:
        t.join(60.0)
        assert not t.is_alive(), "producer hung"
    r.close()
    for t in threads[n_prod:]:
        t.join(60.0)
        assert not t.is_alive(), "consumer hung"
    assert not errors, errors
    assert sorted(produced) == list(range(n_prod * per_prod)), "seq numbers not dense"
    assert consumed == produced, "dropped, duplicated or torn"


T, H, W = 11, 48, 64


def _write(path, frames, fourcc):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 10, (frames.shape[2], frames.shape[1]),
                         fourcc == "RGBA")
    for f in frames:
        vw.write(f[..., ::-1].copy() if f.ndim == 3 else f)
    vw.release()
    return path


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """An RGBA clip and a Y800 clip of 11 random frames (written by cv2)."""
    d = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(3)
    return (_write(d / "rgb.avi", rng.integers(0, 256, (T, H, W, 3), dtype=np.uint8), "RGBA"),
            _write(d / "gray.avi", rng.integers(0, 256, (T, H, W), dtype=np.uint8), "Y800"))


def _windows(prefetcher):
    return [(s, w.copy(), n) for s, w, n in prefetcher]


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("kw", [dict(window=4), dict(window=3, start=2, interval=3, max_frames=3),
                                dict(window=5, start=1, interval=2, depth=1)], ids=["w4", "start-interval", "depth1"])
def test_video_prefetcher_matches_jax(ring_backend, clip_pair, kind, kw):
    """Seqs, n_valid, windows (the 8.8 pack) and the tail window's padding
    equal the JAX package's prefetcher on the same file."""
    path = clip_pair[kind == "gray"]
    mine, ref = _windows(VideoPrefetcher(path, **kw)), _windows(jloader.VideoPrefetcher(path, **kw))
    assert [(s, n) for s, _, n in mine] == [(s, n) for s, _, n in ref] and len(mine) > 0
    for (_, a, n), (_, b, _) in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
        assert (a[n:] == a[n - 1]).all()


def test_stereo_pair_loader_offsets_match_jax(clip_pair):
    """Offset windows of one clip against itself: equal to the JAX
    package's loader, and right window k is left window k two frames on."""
    path = clip_pair[0]
    kw = dict(window=4, left_start=0, right_start=2, max_frames=8)
    mine, ref = list(StereoPairLoader(path, path, **kw)), list(jloader.StereoPairLoader(path, path, **kw))
    assert [(s, n) for s, *_, n in mine] == [(s, n) for s, *_, n in ref] == [(0, 4), (1, 4)]
    gray = jnative.pack_gray(np.stack([f for _, f in jvideo.iter_frames(path)]))
    for (s, wl, wr, _), (_, jl, jr, _) in zip(mine, ref):
        np.testing.assert_array_equal(wl, jl)
        np.testing.assert_array_equal(wr, jr)
        np.testing.assert_array_equal(wr, gray[s * 4 + 2:s * 4 + 6])


def test_decode_errors_surface_on_the_consumer(tmp_path, clip_pair):
    """A missing video raises IOError at once; a file cut inside a frame
    raises on the consumer side after the windows before it."""
    with pytest.raises(IOError):
        VideoPrefetcher(tmp_path / "nope.avi", window=4)
    data = clip_pair[0].read_bytes()
    cut = tmp_path / "cut.avi"
    cut.write_bytes(data[:data.rindex(b"00dc", 0, data.index(b"idx1")) + 100])
    got = []
    with pytest.raises(IOError, match="cut short"):
        for seq, _, n in VideoPrefetcher(cut, window=4):
            got.append((seq, n))
    assert got == [(0, 4), (1, 4)]


SH, SW, ST = 64, 96, 10  # the stream's frames: 10 of 64x96, windows of 4, 4 and 2


@pytest.fixture(scope="module")
def stream_pair(tmp_path_factory):
    """Two RGBA AVIs, crops of one noise image 4 px apart (a constant
    disparity) rolled a row a frame, and the reference test's rig."""
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (SH, SW + 8, 3)).astype(np.uint8)
    left = np.stack([np.roll(base[:, :SW], t, 0) for t in range(ST)])
    right = np.stack([np.roll(base[:, 4:SW + 4], t, 0) for t in range(ST)])
    K = np.array([[200.0, 0, 48.0], [0, 200.0, 32.0], [0, 0, 1.0]])
    dist, size = np.zeros(8), (SW, SH)
    res = ops.stereo_rectify(K, dist, K, dist, size, np.eye(3), np.array([-50.0, 0.0, 0.0]), alpha=0.0, device="cpu")
    maps = tuple(m.numpy().astype(np.float32) for m in (
        *ops.init_undistort_rectify_map(K, dist, res.R1, res.P1, size, device="cpu"),
        *ops.init_undistort_rectify_map(K, dist, res.R2, res.P2, size, device="cpu")))
    return _write(d / "l.avi", left, "RGBA"), _write(d / "r.avi", right, "RGBA"), maps, res.Q.numpy().astype(np.float32)


_JP = {"bm": JBMParams(num_disparities=16, block_size=9, backend="xla"),
       "sgbm": JSGBMParams(num_disparities=16, block_size=3, backend="scan")}


@pytest.mark.parametrize("stats_only", [False, True], ids=["full", "stats"])
@pytest.mark.parametrize("matcher", ["bm", "sgbm"])
def test_stream_video_pair_matches_jax(cpu_mesh, stream_pair, matcher, stats_only):
    left, right, maps, Q = stream_pair
    jp = _JP[matcher]
    params = convert.bm_params_from_reference(jp) if matcher == "bm" else convert.sgbm_params_from_reference(jp)
    jmesh = jcreate_mesh(4, 1, devices=list(cpu_mesh.devices.ravel()))
    ref = list(jstreaming.stream_video_pair(left, right, jmesh, maps, Q, matcher=matcher, params=jp, window=4,
                                            stats_only=stats_only))
    mine = list(streaming.stream_video_pair(left, right, host_cpu_mesh(4), maps, Q, matcher=matcher,
                                            params=params, window=4, stats_only=stats_only))
    assert [(s, n) for s, *_, n in mine] == [(s, n) for s, *_, n in ref] == [(0, 4), (1, 4), (2, 2)]
    for (_, a, pa, _), (_, b, pb, _) in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        if stats_only:
            assert pa is None and pb is None
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(pa, pb, rtol=1e-6)
    if not stats_only:
        assert (mine[0][1] > 0).mean() > 0.5  # the scene is matched, not all invalid


HIER_PARAMS = StereoSGBMParams(num_disparities=128, block_size=5, uniqueness_ratio=10, disp12_max_diff=1,
                               speckle_window_size=30, speckle_range=2, num_paths=3)


def test_stream_video_pair_hier_matches_batched_pipeline(tmp_path):
    """sgbm_hier, 8-frame windows (HIER_FAST by batch size) of 10 frames of
    the ramp+box scene on a 1x1 CPU mesh: every window, full and stats_only,
    equal to the port's batched_stereo_pipeline on the same gray frames,
    the tail window padded with its last frame."""
    hh, ww, n = 48, 192, 10
    frames = [scene(seed=s, H=hh, W=ww) for s in range(n)]
    gl, gr = (np.stack([f[i] for f in frames]).astype(np.uint8) for i in (0, 1))
    left, right = _write(tmp_path / "l.avi", gl, "Y800"), _write(tmp_path / "r.avi", gr, "Y800")
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    maps = tuple(m.astype(np.float32) for m in (xx + 0.35 * np.sin(yy / 4.0), yy - 0.2, xx + 0.1, yy - 0.2))
    Q = np.array([[1, 0, 0, -ww / 2], [0, 1, 0, -hh / 2], [0, 0, 0, 400.0], [0, 0, 12.5, 0]], np.float32)
    mesh = host_cpu_mesh(1)
    full = list(streaming.stream_video_pair(left, right, mesh, maps, Q, params=HIER_PARAMS, window=8))
    stats = list(streaming.stream_video_pair(left, right, mesh, maps, Q, params=HIER_PARAMS, window=8,
                                             stats_only=True))
    assert [(s, k) for s, *_, k in full] == [(s, k) for s, *_, k in stats] == [(0, 8), (1, 2)]
    for (s, disp, pts, k), (_, st, _, _) in zip(full, stats):
        idx = np.minimum(np.arange(s * 8, s * 8 + 8), n - 1)  # the tail repeats its last frame
        d, p = streaming.batched_stereo_pipeline(gl[idx], gr[idx], maps, Q, "sgbm_hier", HIER_PARAMS, device="cpu")
        np.testing.assert_array_equal(disp, d.numpy())
        np.testing.assert_array_equal(pts, p.numpy())
        np.testing.assert_array_equal(st, streaming._frame_stats(d, p).numpy())
    assert (full[0][1][..., 128:] > 0).mean() > 0.5  # right of the range, where the scene can match
