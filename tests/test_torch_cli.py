"""The port's CLI (``pipeline/cli.py``, ``python -m stereo_vision_tpu_torch``)
on the CPU.

The parser's commands and options equal the JAX package's less ``bench``
(its TPU benchmark), each command with one more option, ``--device``
(default ``cuda``). Every command runs in process at ``--device cpu`` on
small synthetic inputs, one user flow through one test directory
(module-scoped), and what it writes and prints is held to the port's
library calls on the same inputs, which the other ``tests/test_torch_*.py``
hold to JAX. The JAX CLI's full stack takes minutes here, so only its
cheap commands (disparity, smooth, measure, analyze) are run beside the
port's, their JSON lines and files compared. The flow:

- intrinsic -> extrinsic -> rectify on a 480x270 rig (f = 375 px, 100 mm
  baseline) filming the 7x4 board, 12 views a camera: the corners those
  frames give, the intrinsic stage on them bit for bit, the baseline
  within 1% of 100 mm, the maps bit for bit;
- sync on a flash pair 15 frames apart (``tests/test_pipeline.py``'s
  flash frames; one frame of the 15 the command samples, as the
  reference's); disparity (sgbm and bm) on a PNG
  pair bit for bit; stream (bm and sgbm_hier at D = 64, window 8, on 48x128
  frames, its video out) per frame equal to ``stream_video_pair``;
- validate-distance on a rendered board pair, ball-drop (``--animate``)
  and pose on short renders, then smooth, animate, measure and analyze on
  what they wrote, each equal to the library;
- without ffmpeg an ``.mp4`` output is raw AVI under the same stem, named
  in the JSON line; with it (a stand-in that encodes with cv2) the
  ``.mp4`` itself; with no card, the default ``--device cuda`` raises.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import stat
import sys

import cv2
import numpy as np
import pytest
import torch

from stereo_vision_tpu.pipeline import cli as jcli
from stereo_vision_tpu_torch import native
from stereo_vision_tpu_torch.detect import find_chessboard_corners
from stereo_vision_tpu_torch.io import png, video
from stereo_vision_tpu_torch.models import pretrained
from stereo_vision_tpu_torch.ops import init_undistort_rectify_map, triangulate_points, undistort_points
from stereo_vision_tpu_torch.parallel.mesh import create_mesh
from stereo_vision_tpu_torch.parallel.streaming import stream_video_pair
from stereo_vision_tpu_torch.pipeline import ArtifactStore, PipelineConfig, cli, measure, run_intrinsic_stage
from stereo_vision_tpu_torch.pipeline import run_rectification_stage, run_sync_stage
from stereo_vision_tpu_torch.pipeline.reporting import smoothing_comparison_stats
from stereo_vision_tpu_torch.stereo import StereoBMParams, StereoSGBMParams, stereo_bm, stereo_sgbm
from stereo_vision_tpu_torch.synth.boards import board_views, render_board_view
from stereo_vision_tpu_torch.synth.scenes import render_ball_drop_stereo, render_pose_stereo, scene
from stereo_vision_tpu_torch.track.ball import analyze_ball_drop, drop_report
from stereo_vision_tpu_torch.track.pose_pipeline import run_pose_workflow
from stereo_vision_tpu_torch.track.smoothing import MotionSmoother
from stereo_vision_tpu_torch.track.validators import validate_distance

CPU = "cpu"
W, H = 480, 270
K = np.array([[375.0, 0, (W - 1) / 2], [0, 375.0, (H - 1) / 2], [0, 0, 1]])
BASELINE = np.array([-100.0, 0.0, 0.0])
VIEWS = 12
FRAMES = ["--start-frame", "0", "--frame-interval", "1", "--max-frames", str(VIEWS)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(*argv) -> tuple[int, list[dict]]:
    """``cli.main`` at --device cpu: its exit code and JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([*argv, "--device", CPU])
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _board_pair(seed: int, n: int):
    obj, c1, c2, p1, p2 = board_views(n, seed, K, np.zeros(5), (W, H), K, np.zeros(5), np.eye(3), BASELINE, cols=7,
                                      rows=4, noise=0.0, margin=40.0, depth=(1800.0, 2600.0), return_poses=True)
    views = [np.stack([render_board_view(K, pr[0][i], pr[1][i], (W, H), 7, 4, device=CPU)[0] for i in range(n)])
             for pr in (p1, p2)]
    return views, (obj, p1)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The user flow through one test directory, without ffmpeg on PATH."""
    assert native.native_available()  # the PNG reader's native filters, built before PATH empties
    root = tmp_path_factory.mktemp("cli")
    empty = root / "empty_path"
    empty.mkdir()
    out: dict = {"root": root}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the tests' own calls run
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", str(empty))
        (root / "videos").mkdir()
        (left, right), _ = _board_pair(1, VIEWS)
        for stage in ("intrinsic", "extrinsic"):
            for side, frames in (("left", left), ("right", right)):
                video.write_video(root / "videos" / f"{side}_{stage}.avi", frames)
        out["board"] = left
        for cmd in ("intrinsic", "extrinsic"):
            out[cmd] = run(cmd, "--test-dir", str(root), *FRAMES)
        out["rectify"] = run("rectify", "--test-dir", str(root), "--size", f"{W}x{H}")
        fl = np.clip(40 + np.random.default_rng(0).normal(0, 2, (150, 12, 12)), 0, 255).astype(np.uint8)
        fr = fl.copy()
        fl[90], fr[105] = 200, 200
        for name, f in (("flash_l.avi", fl), ("flash_r.avi", fr)):
            video.write_video(root / name, f)
        out["flash"] = (fl, fr)
        out["sync"] = run("sync", "--test-dir", str(root), "--left", str(root / "flash_l.avi"), "--right",
                          str(root / "flash_r.avi"))
        pair = scene(seed=2, H=48, W=96)
        for name, img in (("l.png", pair[0]), ("r.png", pair[1])):
            png.write_png(root / name, img.astype(np.uint8))
        for m in ("sgbm", "bm"):
            out[f"disparity_{m}"] = run("disparity", "--test-dir", str(root), "--left", str(root / "l.png"),
                                        "--right", str(root / "r.png"), "--matcher", m, "--num-disparities", "16")
            out[f"disparity_{m}_npy"] = np.load(root / "results/disparity/disparity.npy")
            out[f"disparity_{m}_png"] = png.read_png(root / "results/disparity/disparity.png", grayscale=True)
        frames = [scene(seed=s, H=48, W=128) for s in range(5)]
        for side in (0, 1):
            pair_frames = np.stack([frames[t % 5][side] for t in range(10)]).astype(np.uint8)
            video.write_video(root / f"s{side}.avi", pair_frames)
        for m in ("bm", "sgbm_hier"):
            extra = ["--video-out", str(root / f"d_{m}.mp4")] if m == "bm" else []
            out[f"stream_{m}"] = run("stream", "--test-dir", str(root), "--left", str(root / "s0.avi"), "--right",
                                     str(root / "s1.avi"), "--matcher", m, "--num-disparities", "64", "--window", "8",
                                     *extra)
            out[f"stream_{m}_stats"] = json.loads((root / "results/stream/stream_stats.json").read_text())
        (bl, br), (obj, pose1) = _board_pair(7, 1)
        png.write_png(root / "vl.png", bl[0])
        png.write_png(root / "vr.png", br[0])
        out["truth_mm"] = float(np.linalg.norm((cv2.Rodrigues(pose1[0][0])[0] @ obj.T).T.mean(0) + pose1[1][0]))
        out["validate"] = run("validate-distance", "--test-dir", str(root), "--left", str(root / "vl.png"),
                              "--right", str(root / "vr.png"), "--actual-distance", f"{out['truth_mm']:.1f}")
        rig = ArtifactStore(root).load_rig()
        bl, br, *_ = render_ball_drop_stereo(rig, T=9, H=120, W=160, fps=30.0, hold_frames=2)
        pl, pr, _ = render_pose_stereo(rig, T=7, H=120, W=160, seed=3)
        for name, f in (("ball_l.avi", bl), ("ball_r.avi", br), ("pose_l.avi", pl), ("pose_r.avi", pr)):
            video.write_video(root / name, f)
        out["ball"] = run("ball-drop", "--test-dir", str(root), "--left", str(root / "ball_l.avi"), "--right",
                          str(root / "ball_r.avi"), "--animate")
        out["pose"] = run("pose", "--test-dir", str(root), "--left", str(root / "pose_l.avi"), "--right",
                          str(root / "pose_r.avi"))
        raw = root / "results/pose/pose_3d_original.pkl"
        out["smooth"] = run("smooth", "--input", str(raw), "--preset", "walking")
        smoothed = str(root / "results/pose/pose_3d_smoothed.pkl")
        out["animate"] = run("animate", "--raw", str(raw), "--smoothed", smoothed, "--out", str(root / "anim.mp4"),
                             "--fps", "4", "--duration", "1")
        X = np.array([[0.0, 0.0, 2000.0], [150.0, 20.0, 2100.0]])
        pix = lambda P: (lambda h: h[:, :2] / h[:, 2:])((P @ np.c_[X, np.ones(2)].T).T)  # noqa: E731
        clicks = [measure.ClickMeasurement("pair", pix(rig.P1), pix(rig.P2), expected_mm=float(np.linalg.norm(
            X[0] - X[1])))]
        measure.save_clicks(root / "clicks.json", clicks)
        out["measure"] = run("measure", "--test-dir", str(root), "--clicks", str(root / "clicks.json"), "--out",
                             str(root / "m.json"))
        out["analyze"] = run("analyze", "--results-dir", str(root / "results"))
    torch.set_num_threads(threads)
    return out


def _options(parser) -> dict:
    subs = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {name: sorted((tuple(a.option_strings), a.default, a.required) for a in sp._actions if a.option_strings)
            for name, sp in subs.choices.items()}


def test_parser_matches_jax_less_bench_plus_device():
    mine, ref = _options(cli.build_parser()), _options(jcli.build_parser())
    assert set(ref) - set(mine) == {"bench"} and set(mine) <= set(ref)
    for name, opts in mine.items():
        assert ((("--device",), "cuda", False) in opts), name
        assert sorted(o for o in opts if o[0] != ("--device",)) == ref[name], name
    assert cli.build_parser().prog == "stereo_vision_tpu_torch"


def test_calibration_commands(flow):
    root = flow["root"]
    store = ArtifactStore(root)
    rc, lines = flow["intrinsic"]
    assert rc == 0 and [ln["stage"] for ln in lines] == ["intrinsic/left", "intrinsic/right"]
    frames, idx = video.extract_frames(root / "videos/left_intrinsic.avi", start=0, interval=1, max_frames=VIEWS,
                                       grayscale=True)
    np.testing.assert_array_equal(frames, flow["board"])
    found = [find_chessboard_corners(f, (7, 4), device=CPU) for f in frames]
    corners = np.stack([c for ok, c in found if ok])
    assert len(corners) >= 10 and lines[0]["frames"] <= len(corners)
    ref = ArtifactStore(root / "ref")
    rep = run_intrinsic_stage(ref, PipelineConfig(), {"left": corners}, (W, H), device=CPU)[0]
    assert {k: v for k, v in lines[0].items() if not k.endswith("_ms")} == {
        "stage": rep.name, "status": rep.status, **{k: v for k, v in rep.metrics.items() if not k.endswith("_ms")}}
    for a, b in zip(store.load_intrinsics("left"), ref.load_intrinsics("left")):
        np.testing.assert_array_equal(a, b)
    rc, (ext,) = flow["extrinsic"]
    assert rc == 0 and ext["stage"] == "extrinsic" and ext["status"] == "pass"
    assert abs(ext["baseline_mm"] - 100.0) < 1.0 and ext["rms_px"] < 0.5
    np.testing.assert_allclose(np.linalg.norm(store.load_extrinsics()[1]), ext["baseline_mm"], rtol=1e-12)
    rc, (rect,) = flow["rectify"]
    assert rc == 0 and rect["stage"] == "rectify" and rect["status"] == "pass"
    copy = root / "rect_ref"
    for d in ("intrinsic_params", "extrinsic_params"):
        shutil.copytree(root / "results" / d, copy / "results" / d)
    run_rectification_stage(ArtifactStore(copy), (W, H), device=CPU)
    np.testing.assert_array_equal(np.load(copy / "results/rectification/maps.npy"),
                                  np.load(root / "results/rectification/maps.npy"))
    for a, b in zip(ArtifactStore(copy).load_rectification(), store.load_rectification()):
        np.testing.assert_array_equal(a, b)


def test_sync_and_disparity_commands(flow):
    """sync samples the videos as the reference's command does
    (``extract_frames``' default interval, 15), so the right camera's 15
    frames of lag is an offset of 1 sampled frame."""
    root = flow["root"]
    rc, (line,) = flow["sync"]
    assert rc == 0 and line["offset"] == 1 and line["status"] == "pass"
    rep = run_sync_stage(ArtifactStore(root / "sync_ref"), PipelineConfig(), *(
        video.extract_frames(root / n, max_frames=900, grayscale=True)[0] for n in ("flash_l.avi", "flash_r.avi")),
        device=CPU)
    assert {k: v for k, v in rep.metrics.items() if not k.endswith(("_ms", "_s"))} == {
        k: v for k, v in line.items() if k in rep.metrics and not k.endswith(("_ms", "_s"))}
    assert ArtifactStore(root).load_sync() == ArtifactStore(root / "sync_ref").load_sync()
    left, right = (torch.from_numpy(png.read_png(root / n, grayscale=True)).to(torch.int32) for n in ("l.png", "r.png"))
    for m, fn, params in (("sgbm", stereo_sgbm, StereoSGBMParams(num_disparities=16, block_size=5,
                                                                  uniqueness_ratio=10)),
                          ("bm", stereo_bm, StereoBMParams(num_disparities=16, block_size=5))):
        rc, (line,) = flow[f"disparity_{m}"]
        d = fn(left, right, params).numpy()
        np.testing.assert_array_equal(flow[f"disparity_{m}_npy"], d)
        valid = d > -1
        vis = np.zeros_like(d)
        vis[valid] = d[valid] / max(d[valid].max(), 1e-6) * 255
        np.testing.assert_array_equal(flow[f"disparity_{m}_png"], vis.astype(np.uint8))
        assert rc == 0 and line["valid_fraction"] == float(valid.mean()) and line["mean_disparity"] == float(
            d[valid].mean())
    with contextlib.redirect_stderr(io.StringIO()):
        assert run("disparity", "--test-dir", str(root), "--left", str(root / "none.png"), "--right",
                   str(root / "r.png"))[0] == 2


def test_stream_command_equals_stream_video_pair(flow):
    root = flow["root"]
    store = ArtifactStore(root)
    rig = store.load_rig()
    R1, R2, P1, P2, Q = store.load_rectification()
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    maps = (*init_undistort_rectify_map(t64(rig.K1), t64(rig.d1), t64(R1), t64(P1), (128, 48)),
            *init_undistort_rectify_map(t64(rig.K2), t64(rig.d2), t64(R2), t64(P2), (128, 48)))
    offset = store.load_sync()["frame_offset"]
    for m, params in (("bm", StereoBMParams(num_disparities=64, block_size=5)),
                      ("sgbm_hier", StereoSGBMParams(num_disparities=64, block_size=5, uniqueness_ratio=10))):
        rc, (line,) = flow[f"stream_{m}"]
        assert rc == 0 and line["matcher"] == m and line["frame_offset"] == offset == 1
        assert line["frames"] == 10 - offset and line["size"] == [128, 48]
        ref = []
        for seq, disp, pts, n in stream_video_pair(root / "s0.avi", root / "s1.avi", create_mesh(1, 1, devices=[CPU]),
                                                   maps, t64(Q), matcher=m, params=params, window=8, left_start=0,
                                                   right_start=offset, stats_only=m != "bm"):
            for k in range(n):
                if m == "bm":
                    valid = disp[k] > 0
                    z = pts[k, ..., 2][valid]
                    ref.append({"frame": seq * 8 + k, "valid_fraction": float(valid.mean()),
                                "median_depth_mm": float(np.median(z)) if z.size else None})
                else:
                    med = float(disp[k, 1])
                    ref.append({"frame": seq * 8 + k, "valid_fraction": float(disp[k, 0]),
                                "median_depth_mm": None if np.isnan(med) else med})
        assert flow[f"stream_{m}_stats"] == ref
    line = flow["stream_bm"][1][0]
    assert line["video_out"] == str(root / "d_bm.avi") and not (root / "d_bm.mp4").exists()
    assert video.video_info(root / "d_bm.avi")["frame_count"] == 9


def test_stream_summary_counts_the_ring_waits(flow):
    """The stream command's summary says whether decode or the card paced
    the run: the stream's waits on the frame rings for decoded windows and
    the decode threads' waits for free slots, in seconds, with their calls
    (two rings a run, a get and a put a window of each, and the end)."""
    for m in ("bm", "sgbm_hier"):
        _, (line,) = flow[f"stream_{m}"]
        for key in ("loader_wait_s", "ring_put_wait_s"):
            assert isinstance(line[key], float) and line[key] >= 0.0, (m, key)
        assert line["loader_gets"] >= 2 and line["ring_puts"] >= 2, m


def test_validate_distance_and_analyze_commands(flow):
    root = flow["root"]
    rc, (line,) = flow["validate"]
    store = ArtifactStore(root)
    rig = store.load_rig()
    R1, R2, P1, P2, _ = store.load_rectification()
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    c = [find_chessboard_corners(png.read_png(root / n, grayscale=True), (7, 4), device=CPU)[1].reshape(-1, 2)
         for n in ("vl.png", "vr.png")]
    ul = undistort_points(t64(c[0]), t64(rig.K1), t64(rig.d1), R=t64(R1), P=t64(P1))
    ur = undistort_points(t64(c[1]), t64(rig.K2), t64(rig.d2), R=t64(R2), P=t64(P2))
    actual = float(f"{flow['truth_mm']:.1f}")
    res = validate_distance(triangulate_points(t64(P1)[:3, :4], t64(P2)[:3, :4], ul, ur), actual, 10.0)
    assert rc == 0 and line == {"stage": "validate_distance", **res._asdict()}
    assert res.passed and res.error_percent < 1.0
    saved = json.loads((root / f"results/distance_{int(actual)}_validation.json").read_text())
    assert saved[0]["measured"] == res.measured
    rc, (line,) = flow["analyze"]
    assert rc == 0 and line["runs"] == 1 and line["count"] == 1
    assert (root / "results/validation_report.md").exists() and (root / "results/distance_comparison.png").exists()


def test_ball_drop_pose_and_pose_tools(flow):
    root = flow["root"]
    store = ArtifactStore(root)
    rig = store.load_rig()
    offset = store.load_sync()["frame_offset"]
    rc, (line,) = flow["ball"]
    lf = video.extract_frames(root / "ball_l.avi", interval=1, max_frames=900)[0]
    rf = video.extract_frames(root / "ball_r.avi", start=offset, interval=1, max_frames=900)[0]
    n = min(len(lf), len(rf))
    ld, rd = (pretrained.detect_balls_in_frames(f[:n], score_threshold=0.3, device=CPU) for f in (lf, rf))
    report = drop_report(analyze_ball_drop(rig, ld, rd, fps=30.0, device=CPU))
    assert rc == 0 and line == json.loads(json.dumps({"stage": "ball_drop", "sync_offset": offset, **report,
                                                      "animation": str(root / "results/ball_drop/ball_motion.avi")}))
    assert video.video_info(root / "results/ball_drop/ball_motion.avi")["frame_count"] == n
    rc, (line,) = flow["pose"]
    lf = video.extract_frames(root / "pose_l.avi", interval=1, max_frames=900)[0]
    rf = video.extract_frames(root / "pose_r.avi", start=offset, interval=1, max_frames=900)[0]
    n = min(len(lf), len(rf))
    res = run_pose_workflow(rig, pretrained.pose_landmarks_in_frames(lf[:n], device=CPU),
                            pretrained.pose_landmarks_in_frames(rf[:n], device=CPU), device=CPU)
    with open(root / "results/pose/pose_3d_original.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), res.poses_raw)
    assert rc == 0 and line["frames"] == n == 6 and line["sync_offset"] == offset
    assert sorted(p.name for p in (root / "results/pose").iterdir())[:2] == ["angle_statistics.csv",
                                                                             "angle_statistics.txt"]
    assert (root / "results/pose/angles.png").exists() and (root / "results/pose/trajectory.png").exists()
    rc, (line,) = flow["smooth"]
    smoothed = MotionSmoother("walking", device=CPU).smooth_pose_sequence(res.poses_raw)
    with open(root / "results/pose/pose_3d_resmoothed.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), smoothed)
    stats = smoothing_comparison_stats(res.poses_raw, smoothed, device=CPU)
    assert rc == 0 and line == json.loads(json.dumps({"stage": "smooth", "preset": "walking", **stats,
                                                      "output": str(root / "results/pose/pose_3d_resmoothed.pkl")}))
    rc, (line,) = flow["animate"]
    assert rc == 0 and line == {"stage": "animate", "frames": n, "output": str(root / "anim.avi")}
    assert video.video_info(root / "anim.avi")["frame_count"] == 4 and not (root / "anim.mp4").exists()  # 4 fps x 1 s
    rc, (line,) = flow["measure"]
    clicks = measure.load_clicks(root / "clicks.json")
    ref = [r.to_dict() for r in measure.measure_clicks(
        clicks, rig.K1, rig.d1, rig.K2, rig.d2, rig.P1, rig.P2, device=CPU)]
    assert rc == 0 and line == json.loads(json.dumps({"stage": "measure", "measurements": ref}))
    assert json.loads((root / "m.json").read_text()) == line


_FFMPEG = '''#!{python}
"""A stand-in for ffmpeg's encoder, encoding with cv2 (tests only)."""
import sys
import cv2, numpy as np
argv = sys.argv[1:]
w, h = map(int, argv[argv.index("-s") + 1].split("x"))
vw = cv2.VideoWriter(argv[-1], cv2.VideoWriter_fourcc(*"mp4v"), float(argv[argv.index("-r") + 1]), (w, h))
while True:
    buf = sys.stdin.buffer.read(w * h * 3)
    if len(buf) < w * h * 3:
        break
    vw.write(np.frombuffer(buf, np.uint8).reshape(h, w, 3)[..., ::-1].copy())
vw.release()
'''


def test_mp4_outputs_with_ffmpeg_and_the_default_device(flow, tmp_path, monkeypatch):
    root = flow["root"]
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "ffmpeg").write_text(_FFMPEG.format(python=sys.executable))
    (bindir / "ffmpeg").chmod((bindir / "ffmpeg").stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    rc, (line,) = run("animate", "--raw", str(root / "results/pose/pose_3d_original.pkl"), "--smoothed",
                      str(root / "results/pose/pose_3d_smoothed.pkl"), "--out", str(tmp_path / "a.mp4"), "--fps",
                      "2", "--duration", "1")
    assert rc == 0 and line["output"] == str(tmp_path / "a.mp4")
    assert cv2.VideoCapture(str(tmp_path / "a.mp4")).get(cv2.CAP_PROP_FRAME_COUNT) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["rectify", "--test-dir", str(root)])


def _jax_run(*argv) -> tuple[int, list[dict]]:
    """The JAX package's ``cli.main``: its exit code and JSON lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jcli.main(list(argv))
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


def _same_json(a, b, rel: float) -> None:
    """Two JSON values alike: the same keys, lengths, strings and flags, the
    numbers within ``rel`` of each other (NaN where the other is NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _same_json(a[k], b[k], rel)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same_json(x, y, rel)
    elif isinstance(a, float) and not isinstance(b, bool) and isinstance(b, (int, float)):
        assert b == pytest.approx(a, rel=rel, abs=1e-12, nan_ok=True), (a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


def test_cheap_commands_match_the_jax_cli(flow, tmp_path):
    """disparity, smooth, measure and analyze, the JAX CLI's commands that
    take seconds here, run by both CLIs on the same inputs: the same exit
    codes and JSON lines (keys and values; the output paths name each run's
    own directory) and the same files."""
    root, jroot = flow["root"], tmp_path
    for m in ("sgbm", "bm"):
        rc, lines = _jax_run("disparity", "--test-dir", str(jroot), "--left", str(root / "l.png"), "--right",
                             str(root / "r.png"), "--matcher", m, "--num-disparities", "16")
        mine_rc, mine = flow[f"disparity_{m}"]
        assert (rc, lines) == (mine_rc, [{**ln, "output": str(jroot / "results/disparity/disparity.npy")}
                                         for ln in mine]), m
        np.testing.assert_array_equal(np.load(jroot / "results/disparity/disparity.npy"), flow[f"disparity_{m}_npy"])
        np.testing.assert_array_equal(cv2.imread(str(jroot / "results/disparity/disparity.png"), cv2.IMREAD_UNCHANGED),
                                      flow[f"disparity_{m}_png"])
    raw = root / "results/pose/pose_3d_original.pkl"
    rc, lines = _jax_run("smooth", "--input", str(raw), "--preset", "walking", "--out", str(jroot / "s.pkl"))
    mine_rc, mine = flow["smooth"]
    assert rc == mine_rc == 0
    _same_json(lines, [{**ln, "output": str(jroot / "s.pkl")} for ln in mine], 1e-6)
    with open(jroot / "s.pkl", "rb") as f, open(root / "results/pose/pose_3d_resmoothed.pkl", "rb") as g:
        np.testing.assert_allclose(pickle.load(g), pickle.load(f), rtol=1e-6, atol=1e-6)
    rc, lines = _jax_run("measure", "--test-dir", str(root), "--clicks", str(root / "clicks.json"), "--out",
                         str(jroot / "m.json"))
    mine_rc, mine = flow["measure"]
    assert rc == mine_rc == 0
    _same_json(lines, mine, 1e-9)
    _same_json(json.loads((jroot / "m.json").read_text()), json.loads((root / "m.json").read_text()), 1e-9)
    rc, lines = _jax_run("analyze", "--results-dir", str(root / "results"), "--out", str(jroot / "analyze"))
    mine_rc, mine = flow["analyze"]
    assert (rc, lines) == (mine_rc, [{**ln, "report": str(jroot / "analyze/validation_report.md")} for ln in mine])
    assert (jroot / "analyze/validation_report.md").read_text() == (root / "results/validation_report.md").read_text()
    assert (jroot / "analyze/distance_comparison.png").exists()
