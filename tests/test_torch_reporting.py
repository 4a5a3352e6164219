"""The port's reports, measurements, drawings and images against the JAX
package's, on the CPU: ``pipeline/measure.py``, ``aggregation.py``,
``reporting.py``, ``animations.py``, ``video_viz.py``, ``drawing.py`` and
``io/png.py``.

- ``measure_clicks`` within rtol 1e-9 of JAX's (float64 both; the clicks,
  the rig and its rectification from ``tests/test_measure.py``'s setting);
  the clicks file read and written alike;
- the aggregation's records, table and metrics equal JAX's, its markdown
  report and metrics JSON equal byte for byte, its three plots written;
- ``smoothing_comparison_stats`` within rtol 1e-9, each plotting function's
  file written; ``write_sync_report`` equal but for its date line;
- the PNG reader and writer bit for bit both ways against ``cv2.imread`` /
  ``cv2.imwrite`` (gray and colour, every filter strategy, the gray
  conversion of a colour file);
- the drawings by their mean absolute difference from OpenCV's on 300x200
  frames: filled circles equal, 1-px lines under 3 (1.9 measured: lines
  clipped at the frame's edge are walked another way), thick lines under 4
  (2.4), rings under 0.5 (0.29); the sync snapshots within 3 of JAX's,
  bit for bit below the labels (cv2 5 draws FONT_HERSHEY_SIMPLEX with an
  outline font, the port with Hershey's strokes: 2.1-2.3 measured over a
  240x640 pair of noise frames), the skeleton and ball overlays within 2
  of the frames JAX's renderers hand their writer (1.13 and 0.29 measured
  on 72x96 noise frames: the thick lines' rims);
- the animations' videos: an ``.mp4`` name written as raw AVI under the
  same stem without ffmpeg, and through ffmpeg (a stand-in that encodes
  with cv2) with it; the rolling animation's frames within 1 of JAX's
  (both drawn by matplotlib; JAX's read back through cv2);
- without matplotlib, the package imports and every plot raises the
  documented ``ImportError`` (a subprocess that blocks the import).
"""

import json
import os
import pickle
import stat
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from stereo_vision_tpu.pipeline import aggregation as jaggregation
from stereo_vision_tpu.pipeline import animations as janimations
from stereo_vision_tpu.pipeline import measure as jmeasure
from stereo_vision_tpu.pipeline import reporting as jreporting
from stereo_vision_tpu.pipeline import video_viz as jvideo_viz
from stereo_vision_tpu.track.validators import ValidationResult as JValidationResult
from stereo_vision_tpu_torch.io import png, video
from stereo_vision_tpu_torch.pipeline import aggregation, animations, drawing, measure, reporting, video_viz
from stereo_vision_tpu_torch.track.validators import ValidationResult

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rig():
    K1 = np.array([[1200.0, 0, 640.0], [0, 1200.0, 360.0], [0, 0, 1]])
    K2 = np.array([[1180.0, 0, 650.0], [0, 1185.0, 355.0], [0, 0, 1]])
    d1, d2 = np.array([-0.1, 0.05, 0.001, -0.001, 0.0]), np.array([-0.08, 0.03, 0.0, 0.0, 0.0])
    R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    T = np.array([-120.0, 1.0, 0.5])
    return K1, d1, K2, d2, R, T


def test_measure_clicks_match_jax(tmp_path):
    K1, d1, K2, d2, R, T = _rig()
    P1 = K1 @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K2 @ np.hstack([R, T.reshape(3, 1)])
    X = np.array([[100.0, 50.0, 2000.0], [400.0, -30.0, 2500.0], [0.0, 0.0, 1800.0]])
    pix = lambda P: (lambda h: h[:, :2] / h[:, 2:])((P @ np.c_[X, np.ones(3)].T).T)  # noqa: E731
    clicks = [measure.ClickMeasurement("pair", pix(P1)[:2], pix(P2)[:2], expected_mm=float(
        np.linalg.norm(X[0] - X[1]))), measure.ClickMeasurement("one", pix(P1)[2:], pix(P2)[2:], expected_mm=1800.0),
        measure.ClickMeasurement("free", pix(P1), pix(P2))]
    measure.save_clicks(tmp_path / "c.json", clicks)
    jclicks = jmeasure.load_clicks(tmp_path / "c.json")
    mine_clicks = measure.load_clicks(tmp_path / "c.json")
    jmeasure.save_clicks(tmp_path / "j.json", jclicks)
    assert (tmp_path / "c.json").read_text() == (tmp_path / "j.json").read_text()
    R1, R2, P1r, P2r, _, _, _ = cv2.stereoRectify(K1, d1, K2, d2, (1280, 720), R, T.reshape(3, 1))
    for kw in ({}, {"R1": R1, "R2": R2}):
        Pa, Pb = (P1r, P2r) if kw else (P1, P2)
        mine = measure.measure_clicks(mine_clicks, K1, d1, K2, d2, Pa, Pb, device=CPU, **kw)
        ref = jmeasure.measure_clicks(jclicks, K1, d1, K2, d2, Pa, Pb, **kw)
        for a, b in zip(mine, ref):
            da, db = a.to_dict(), b.to_dict()
            assert sorted(da) == sorted(db)
            np.testing.assert_allclose(a.points_3d, b.points_3d, rtol=1e-9)
            np.testing.assert_allclose(a.camera_distance_mm, b.camera_distance_mm, rtol=1e-9)
            if b.distance_mm is not None:
                np.testing.assert_allclose(a.distance_mm, b.distance_mm, rtol=1e-9)
            if b.validation is not None:
                assert a.validation.passed == b.validation.passed and a.validation.name == b.validation.name
                np.testing.assert_allclose(a.validation.measured, b.validation.measured, rtol=1e-9)
    with pytest.raises(ValueError, match="click counts differ"):
        (tmp_path / "bad.json").write_text(json.dumps({"measurements": [{"left": [[1, 2]], "right": []}]}))
        measure.load_clicks(tmp_path / "bad.json")


def _validation_dir(tmp, Result) -> Path:
    d = tmp / "results"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for dist in (1000, 2000, 3500):
        rs = [Result.make("distance", dist * (1 + rng.normal(0, 0.03)), float(dist), 10.0)]
        jaggregation.save_run_results(rs, d / f"distance_{dist}_validation.json", source=f"distance_{dist}")
    with open(d / "run_2500mm_validation_results.pkl", "wb") as f:
        pickle.dump([{"measured_distance_mm": 2437.5}, {"measured_distance_mm": 2561.0, "actual_distance_mm": 2500}], f)
    (d / "corrupt_validation_results.pkl").write_bytes(b"not a pickle")
    return d


def test_aggregation_matches_jax(tmp_path):
    d = _validation_dir(tmp_path, JValidationResult)
    mine, ref = aggregation.collect_run_results(d), jaggregation.collect_run_results(d)
    assert mine == ref and len(mine) == 5
    assert aggregation.overall_metrics(mine) == jaggregation.overall_metrics(ref)
    assert aggregation.error_vs_distance_table(mine) == jaggregation.error_vs_distance_table(ref)
    assert aggregation.overall_metrics([]) is None
    p = aggregation.generate_validation_report(mine, tmp_path / "p")
    q = jaggregation.generate_validation_report(ref, tmp_path / "j")
    assert p.read_text() == q.read_text()
    assert (tmp_path / "p/validation_metrics.json").read_text() == (tmp_path / "j/validation_metrics.json").read_text()
    for name in ("distance_comparison.png", "distance_error.png", "error_distribution.png"):
        assert (tmp_path / "p" / name).read_bytes().startswith(b"\x89PNG"), name
    aggregation.generate_validation_report([], tmp_path / "e", plots=False)
    jaggregation.generate_validation_report([], tmp_path / "je", plots=False)
    assert (tmp_path / "e/validation_report.md").read_text() == (tmp_path / "je/validation_report.md").read_text()
    aggregation.save_run_results([ValidationResult.make("ruler", 300.0, 304.8, 10.0)], tmp_path / "r.json", "r")
    jaggregation.save_run_results([JValidationResult.make("ruler", 300.0, 304.8, 10.0)], tmp_path / "jr.json", "r")
    assert (tmp_path / "r.json").read_text() == (tmp_path / "jr.json").read_text()


def test_reporting_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    seq = np.cumsum(rng.normal(0, 5, (30, 13, 3)), axis=0) + rng.normal(0, 300, (1, 13, 3))
    sm = seq + rng.normal(0, 1, seq.shape)
    mine = reporting.smoothing_comparison_stats(seq, sm, device=CPU)
    ref = jreporting.smoothing_comparison_stats(seq, sm)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(mine[k], v, rtol=1e-9, err_msg=k)
    R = cv2.Rodrigues(np.array([0.0, 0.1, 0.0]))[0]
    mx, my = np.meshgrid(np.arange(128.0), np.arange(96.0))
    img = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    angles = rng.uniform(0, 180, (30, 8))
    vals = [ValidationResult.make("distance", 2480.0, 2500.0, 10.0)]
    for fn, args in ((reporting.save_rectification_preview, (img, img)),
                     (reporting.save_distortion_map, (mx + 0.5, my - 0.25)),
                     (reporting.save_camera_pose_plot, (R, np.array([-100.0, 0, 0]))),
                     (reporting.save_angle_series, (angles, 30.0)),
                     (reporting.save_trajectory_3d, (seq,)),
                     (reporting.save_occlusion_heatmap, (rng.integers(0, 30, (8, 4)),))):
        out = fn(*args, tmp_path / f"{fn.__name__}.png")
        assert out == tmp_path / f"{fn.__name__}.png" and out.read_bytes().startswith(b"\x89PNG")
    pdf = reporting.save_calibration_report(tmp_path / "r.pdf", {"left": {"K": np.eye(3), "dist": np.zeros(5),
                                                                          "rms": 0.2}},
                                            {"baseline": 100.0, "rms": 0.3, "R": R, "T": [-100, 0, 0]}, vals)
    assert pdf.read_bytes().startswith(b"%PDF")
    info = {"left_video": "l.avi", "right_video": "r.avi", "left_flash_frame": 3, "right_flash_frame": 8,
            "frame_offset": 5, "left_fps": 30.0, "right_fps": 29.97, "left_frame_count": 90}
    a = animations.write_sync_report(info, tmp_path / "p/sync.txt").read_text().splitlines()
    b = janimations.write_sync_report(info, tmp_path / "j/sync.txt").read_text().splitlines()
    assert len(a) == len(b) and [x for x in a if not x.startswith("Date:")] == [x for x in b if not
                                                                                x.startswith("Date:")]


def test_png_both_ways_against_opencv(tmp_path):
    rng = np.random.default_rng(2)
    ramp = ((np.arange(90)[:, None] + np.arange(130)[None]) % 256).astype(np.uint8)
    for img in (rng.integers(0, 256, (37, 53), dtype=np.uint8), ramp,
                rng.integers(0, 256, (40, 61, 3), dtype=np.uint8), np.dstack([ramp, ramp[::-1], 255 - ramp])):
        for strategy in range(5):
            cv2.imwrite(str(tmp_path / "c.png"), img[..., ::-1] if img.ndim == 3 else img,
                        [cv2.IMWRITE_PNG_STRATEGY, strategy, cv2.IMWRITE_PNG_COMPRESSION, 9])
            got = png.read_png(tmp_path / "c.png")
            np.testing.assert_array_equal(got if img.ndim == 3 else got[..., 0], img)
            np.testing.assert_array_equal(png.read_png(tmp_path / "c.png", grayscale=True),
                                          cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_GRAYSCALE))
        png.write_png(tmp_path / "p.png", img)
        back = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3 else back, img)
        np.testing.assert_array_equal(png.read_png(tmp_path / "p.png", grayscale=True),
                                      cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_GRAYSCALE))
    from stereo_vision_tpu_torch import native

    rows = np.concatenate([np.arange(5, dtype=np.uint8)[:, None], rng.integers(0, 256, (5, 12), dtype=np.uint8)], 1)
    assert native.native_available()
    fast = native.png_unfilter(rows, 5, 12, 3)
    native._mods["host_ops"] = None  # the numpy / Python fall-back gives the same bytes
    try:
        np.testing.assert_array_equal(native.png_unfilter(rows, 5, 12, 3), fast)
    finally:
        native._mods.pop("host_ops")
    with pytest.raises(IOError, match="not a PNG"):
        (tmp_path / "x.png").write_bytes(b"GIF89a")
        png.read_png(tmp_path / "x.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        cv2.imwrite(str(tmp_path / "d.png"), np.zeros((4, 4), np.uint16))
        png.read_png(tmp_path / "d.png")


def test_drawings_near_opencv():
    rng = np.random.default_rng(3)
    mad = lambda a, b: np.abs(a.astype(np.int16) - b).mean()  # noqa: E731
    for kind, limit in (("line1", 3.0), ("line2", 4.0), ("disk", 0.0), ("ring", 0.5)):
        a = np.zeros((200, 300, 3), np.uint8)
        b = a.copy()
        for _ in range(20):
            p, q = (tuple(int(v) for v in rng.integers(-20, 320, 2)) for _ in range(2))
            r = int(rng.integers(2, 30))
            if kind.startswith("line"):
                cv2.line(a, p, q, (255, 255, 0), int(kind[-1]))
                drawing.draw_line(b, p, q, (255, 255, 0), int(kind[-1]))
            else:
                cv2.circle(a, p, r, (0, 255, 0), -1 if kind == "disk" else 2)
                drawing.draw_circle(b, p, r, (0, 255, 0), -1 if kind == "disk" else 2)
        assert mad(a, b) <= limit, (kind, mad(a, b))
    img = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    np.testing.assert_array_equal(drawing.resize_linear(img, 91, 33), cv2.resize(img, (91, 33)))
    np.testing.assert_array_equal(drawing.resize_linear(img[..., 0], 40, 80), cv2.resize(img[..., 0], (40, 80)))


def test_sync_visualizations_and_overlays_near_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    left = rng.integers(0, 256, (3, 240, 320), dtype=np.uint8)
    right = rng.integers(0, 256, (3, 180, 240, 3), dtype=np.uint8)
    pairs = [(10, 15), (11, 16), (12, 17)]
    mine = animations.save_sync_visualizations(left, right, pairs, tmp_path / "p", sample_count=2)
    ref = janimations.save_sync_visualizations(left, right, pairs, tmp_path / "j", sample_count=2)
    assert [p.name for p in mine] == [p.name for p in ref] == ["sync_visualization_00.png", "sync_visualization_01.png"]
    for a, b in zip(mine, ref):
        x, y = png.read_png(a), cv2.imread(str(b))[..., ::-1]
        assert x.shape == y.shape == (240, 640, 3)
        np.testing.assert_array_equal(x[40:, 320:], y[40:, 320:])  # the resized frame, below the text, bit for bit
        np.testing.assert_array_equal(x[40:], y[40:])
        assert np.abs(x.astype(np.int16) - y).mean() < 3.0
    frames = rng.integers(0, 256, (4, 72, 96, 3), dtype=np.uint8)
    joints = rng.uniform(5, 90, (4, 13, 2))
    joints[1, 3] = np.nan
    centers = np.c_[np.linspace(10, 80, 4), np.linspace(10, 60, 4)]
    centers[2] = np.nan
    import stereo_vision_tpu.io.video as jvideo

    drawn = {}
    monkeypatch.setattr(jvideo, "write_video", lambda path, f, fps=30.0: drawn.setdefault(Path(path).name, f))
    for fn, jfn, args in ((video_viz.render_skeleton_video, jvideo_viz.render_skeleton_video, (joints,)),
                          (video_viz.render_ball_video, jvideo_viz.render_ball_video, (centers, np.full(4, 6.0)))):
        a = fn(frames, *args, tmp_path / f"{fn.__name__}.avi")
        jfn(frames, *args, tmp_path / f"{fn.__name__}.mp4")
        x, y = video.extract_frames(a, interval=1)[0], drawn[f"{fn.__name__}.mp4"]
        assert x.shape == y.shape and np.abs(x.astype(np.int16) - y).mean() < 2.0, fn.__name__


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


def test_animations_write_avi_without_ffmpeg_and_mp4_with_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    raw = np.cumsum(rng.normal(0, 5, (6, 13, 3)), axis=0) + 1000.0
    xy = np.c_[np.linspace(100, 200, 6), np.linspace(50, 300, 6)]
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert animations.video_path(tmp_path / "a.mp4") == tmp_path / "a.avi"
    assert animations.video_path(tmp_path / "a.avi") == tmp_path / "a.avi"
    out = animations.create_pose_comparison_video(raw, raw + 1.0, tmp_path / "pose.mp4", fps=4.0, duration=1.0)
    assert out == tmp_path / "pose.avi" and not (tmp_path / "pose.mp4").exists()
    frames = video.extract_frames(out, interval=1)[0]
    assert frames.shape[0] == 4 and frames.ndim == 4
    out = animations.create_rolling_animation(xy, xy + 3.0, np.arange(6) / 30.0, tmp_path / "ball.mp4", max_frames=3)
    assert out == tmp_path / "ball.avi" and video.video_info(out)["frame_count"] == 3
    import stereo_vision_tpu.io.video as jvideo

    drawn = {}
    monkeypatch.setattr(jvideo, "write_video", lambda path, f, fps=30.0: drawn.setdefault("ball", f))
    janimations.create_rolling_animation(xy, xy + 3.0, np.arange(6) / 30.0, tmp_path / "jball.mp4", max_frames=3)
    got, want = video.extract_frames(out, interval=1)[0], drawn["ball"]
    assert got.shape == want.shape and np.abs(got.astype(np.int16) - want).mean() < 1.0
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "ffmpeg").write_text(_FFMPEG.format(python=sys.executable))
    (bindir / "ffmpeg").chmod((bindir / "ffmpeg").stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{empty}")
    out = animations.create_rolling_animation(xy, xy, np.arange(6) / 30.0, tmp_path / "ball2.mp4", max_frames=2)
    assert out == tmp_path / "ball2.mp4" and cv2.VideoCapture(str(out)).get(cv2.CAP_PROP_FRAME_COUNT) == 2


def test_plots_raise_import_error_without_matplotlib():
    """The package imports without matplotlib; a plot, an animation, the
    aggregation's report and the pose workflow's best-effort plots say so
    (the last writes its other files)."""
    code = (
        "import sys, tempfile, pathlib, numpy as np\n"
        "sys.modules['matplotlib'] = None\n"
        "import stereo_vision_tpu_torch.pipeline as p\n"
        "from stereo_vision_tpu_torch.pipeline import reporting, animations, aggregation\n"
        "calls = [lambda: reporting.save_angle_series(np.zeros((3, 8)), 30.0, 'a.png'),\n"
        "         lambda: animations.create_rolling_animation(np.zeros((2, 2)), np.zeros((2, 2)),\n"
        "                                                     np.arange(2.0), 'b.avi'),\n"
        "         lambda: aggregation.generate_validation_report([{'actual_distance_mm': 1.0,\n"
        "             'measured_distance_mm': 1.0, 'distance_error_percent': 0.0, 'distance_error_mm': 0.0}], 'x')]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert str(e) == reporting.MATPLOTLIB_MISSING, e\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "print('ok', len(p.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "23"]


def test_pipeline_exports_match_jax():
    from stereo_vision_tpu import pipeline as jpipeline
    from stereo_vision_tpu_torch import pipeline

    assert pipeline.__all__ == jpipeline.__all__
    for name in pipeline.__all__:
        assert getattr(pipeline, name).__name__ == getattr(jpipeline, name).__name__
