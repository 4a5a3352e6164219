"""Command-line interface.

Port of ``stereo_vision_tpu/pipeline/cli.py``: the same commands, options
and JSON lines, on the CUDA card. It replaces the reference's per-script
argparse mains and shell menu (reference: intrinsic.py:450-536,
extrinsic.py:567-, 3dpose.py:1296-1351, ball_drop.py:783-, flash_sync CLI,
SCRIPT_RUNNER.sh) with one typed entry point:

  python -m stereo_vision_tpu_torch intrinsic  --test-dir T [--board 7x4 --square 100]
  python -m stereo_vision_tpu_torch extrinsic  --test-dir T [--actual-distance D]
  python -m stereo_vision_tpu_torch rectify    --test-dir T --size 1920x1080
  python -m stereo_vision_tpu_torch sync       --test-dir T --left L.avi --right R.avi
  python -m stereo_vision_tpu_torch disparity  --test-dir T --left L.png --right R.png
  python -m stereo_vision_tpu_torch stream     --test-dir T --left L.avi --right R.avi
  python -m stereo_vision_tpu_torch pose       --test-dir T --left L.avi --right R.avi
  python -m stereo_vision_tpu_torch ball-drop  --test-dir T --left L.avi --right R.avi
  python -m stereo_vision_tpu_torch smooth     --input pose_3d_original.pkl
  python -m stereo_vision_tpu_torch animate    --raw A.pkl --smoothed B.pkl --out V.mp4
  python -m stereo_vision_tpu_torch validate-distance --test-dir T --left L.png --right R.png --actual-distance D
  python -m stereo_vision_tpu_torch measure    --test-dir T --clicks C.json
  python -m stereo_vision_tpu_torch analyze    --results-dir T/results

Every command takes ``--device`` (default ``cuda``: the card; ``cpu`` runs
the plain PyTorch forms, as the tests do; no quiet fall-back). The JAX
package's ``bench`` command (its TPU benchmark, ``bench.py``) has no
counterpart here. Images are PNG (``io.png``); videos decode as ``io.video``
decodes them (raw AVI in numpy, other containers through ffmpeg). A video
written to an ``.mp4`` name (``ball-drop --animate``, ``animate --out``,
``stream --video-out``) is raw AVI under the same stem where ffmpeg is not
on PATH, and the command's JSON line names the file written.

The test-dir layout convention follows the reference
(stereo_calibration/README.md:9-34): videos under <test-dir>/videos/,
results under <test-dir>/results/.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device


def _device(args) -> torch.device:
    """``--device``: ``cuda`` (the default) is the card, and raises where
    there is none; any other torch device name as given."""
    return resolve_device(None if args.device == "cuda" else args.device)


def _parse_pair(s: str, sep: str = "x") -> tuple[int, int]:
    a, b = s.lower().split(sep)
    return int(a), int(b)


def _detect_corners_from_video(video, board, frames_cfg, device):
    from stereo_vision_tpu_torch.detect.checkerboard import find_chessboard_corners
    from stereo_vision_tpu_torch.io.video import extract_frames

    frames, idx = extract_frames(
        video,
        start=frames_cfg.start_frame,
        interval=frames_cfg.interval,
        max_frames=frames_cfg.max_frames,
        grayscale=True,
    )
    corners, kept = [], []
    for f, i in zip(frames, idx):
        ok, c = find_chessboard_corners(f, board, backend="auto", device=device)
        if ok:
            corners.append(c)
            kept.append(i)
    if not corners:
        return None, None, None
    size = (frames.shape[2], frames.shape[1])
    return np.stack(corners), np.asarray(kept), size


def _frames_config(args):
    from stereo_vision_tpu_torch.pipeline.config import FrameExtractionConfig

    return FrameExtractionConfig(
        interval=args.frame_interval,
        max_frames=args.max_frames,
        start_frame=args.start_frame,
    )


def cmd_intrinsic(args) -> int:
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.pipeline.config import PipelineConfig, BoardConfig
    from stereo_vision_tpu_torch.pipeline.stages import run_intrinsic_stage
    from stereo_vision_tpu_torch.io.video import find_video

    cols, rows = _parse_pair(args.board)
    cfg = PipelineConfig(
        board=BoardConfig(cols, rows, args.square), frames=_frames_config(args)
    )
    store = ArtifactStore(args.test_dir)
    dev = _device(args)
    if args.skip_existing:
        # v4 runner resume semantics (runner.py:118,182-190): a stage with
        # existing output artifacts is skipped, not recomputed.
        try:
            for cam in ("left", "right"):
                store.load_intrinsics(cam)
        except (FileNotFoundError, OSError):
            pass
        else:
            print(json.dumps({"stage": "intrinsic", "status": "skipped",
                              "reason": "existing artifacts"}))
            return 0
    detections, size = {}, None
    for cam in ("left", "right"):
        video = find_video(Path(args.test_dir) / "videos", f"{cam}_intrinsic")
        if video is None:
            print(f"no {cam}_intrinsic video found", file=sys.stderr)
            return 2
        c, _, size = _detect_corners_from_video(video, cfg.board.size, cfg.frames, dev)
        if c is None:
            print(f"no checkerboards detected for {cam}", file=sys.stderr)
            return 2
        detections[cam] = c
    reports = run_intrinsic_stage(store, cfg, detections, size, device=dev)
    for r in reports:
        print(json.dumps({"stage": r.name, "status": r.status, **r.metrics}))
    return 0


def cmd_extrinsic(args) -> int:
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.pipeline.config import PipelineConfig, BoardConfig, StereoConfig
    from stereo_vision_tpu_torch.pipeline.stages import run_extrinsic_stage
    from stereo_vision_tpu_torch.io.video import find_video

    cols, rows = _parse_pair(args.board)
    cfg = PipelineConfig(
        board=BoardConfig(cols, rows, args.square),
        stereo=StereoConfig(actual_baseline_mm=args.actual_distance),
        frames=_frames_config(args),
    )
    store = ArtifactStore(args.test_dir)
    dev = _device(args)
    if args.skip_existing:
        try:
            store.load_extrinsics()
        except (FileNotFoundError, OSError):
            pass
        else:
            print(json.dumps({"stage": "extrinsic", "status": "skipped",
                              "reason": "existing artifacts"}))
            return 0
    per_cam, size = {}, None
    for cam in ("left", "right"):
        video = find_video(Path(args.test_dir) / "videos", f"{cam}_extrinsic")
        if video is None:
            print(f"no {cam}_extrinsic video found", file=sys.stderr)
            return 2
        c, kept, size = _detect_corners_from_video(video, cfg.board.size, cfg.frames, dev)
        per_cam[cam] = (c, kept)
    # Key-join on frame index (extrinsic.py:350-374 semantics).
    lk = {int(i): c for c, i in zip(*per_cam["left"])}
    rk = {int(i): c for c, i in zip(*per_cam["right"])}
    common = sorted(set(lk) & set(rk))
    if not common:
        print("no matching stereo frames", file=sys.stderr)
        return 2
    cl = np.stack([lk[i] for i in common])
    cr = np.stack([rk[i] for i in common])
    rep = run_extrinsic_stage(store, cfg, cl, cr, size, device=dev)
    print(json.dumps({"stage": rep.name, "status": rep.status, **rep.metrics}))
    return 0


def cmd_rectify(args) -> int:
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.pipeline.stages import run_rectification_stage

    store = ArtifactStore(args.test_dir)
    rep = run_rectification_stage(store, _parse_pair(args.size), device=_device(args))
    print(json.dumps({"stage": rep.name, "status": rep.status, **rep.metrics}))
    return 0


def cmd_sync(args) -> int:
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.pipeline.config import PipelineConfig
    from stereo_vision_tpu_torch.pipeline.stages import run_sync_stage
    from stereo_vision_tpu_torch.io.video import extract_frames

    lf, _ = extract_frames(args.left, max_frames=args.max_frames, grayscale=True)
    rf, _ = extract_frames(args.right, max_frames=args.max_frames, grayscale=True)
    rep = run_sync_stage(ArtifactStore(args.test_dir), PipelineConfig(), lf, rf, device=_device(args))
    print(json.dumps({"stage": rep.name, "status": rep.status, **rep.metrics}))
    return 0


def cmd_disparity(args) -> int:
    from stereo_vision_tpu_torch.io.png import read_png, write_png
    from stereo_vision_tpu_torch.stereo import (
        StereoBMParams,
        StereoSGBMParams,
        stereo_bm,
        stereo_sgbm,
    )

    dev = _device(args)
    try:
        left = read_png(args.left, grayscale=True)
        right = read_png(args.right, grayscale=True)
    except (IOError, ValueError):
        print("could not read images", file=sys.stderr)
        return 2
    left, right = (torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (left, right))
    if args.matcher == "bm":
        disp = stereo_bm(
            left,
            right,
            StereoBMParams(num_disparities=args.num_disparities, block_size=args.block_size),
        )
    else:
        disp = stereo_sgbm(
            left,
            right,
            StereoSGBMParams(
                num_disparities=args.num_disparities,
                block_size=args.block_size,
                uniqueness_ratio=10,
            ),
        )
    d = disp.cpu().numpy()
    out = Path(args.test_dir) / "results" / "disparity"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "disparity.npy", d)
    valid = d > -1
    vis = np.zeros_like(d)
    if valid.any():
        vis[valid] = d[valid] / max(d[valid].max(), 1e-6) * 255
    write_png(out / "disparity.png", vis.astype(np.uint8))
    print(
        json.dumps(
            {
                "stage": "disparity",
                "valid_fraction": float(valid.mean()),
                "mean_disparity": float(d[valid].mean()) if valid.any() else None,
                "output": str(out / "disparity.npy"),
            }
        )
    )
    return 0


def cmd_stream(args) -> int:
    """Streaming stereo video -> rectify -> disparity -> depth (BASELINE
    config #5 as a tool). Replaces the reference's serial per-frame decode
    loop (3dpose.py:358, ball_drop.py:380) with windows on the card: the
    native frame-ring decode overlapped with the pinned-staging upload and
    the remap->matcher->Q pipeline (parallel.streaming.stream_video_pair).
    With ``--device cuda`` the mesh is the machine's cards (``--devices`` of
    them); with another device, ``--devices`` logical shards of it."""
    import time

    from stereo_vision_tpu_torch.io.video import VideoSink, video_info
    from stereo_vision_tpu_torch.ops.rectify import init_undistort_rectify_map
    from stereo_vision_tpu_torch.parallel.mesh import create_mesh
    from stereo_vision_tpu_torch.pipeline.animations import video_path
    from stereo_vision_tpu_torch.parallel.streaming import stream_video_pair
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
    from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams
    from stereo_vision_tpu_torch.utils.profiling import counters

    dev = _device(args)
    store = ArtifactStore(args.test_dir)
    try:
        rig = store.load_rig()
        R1, R2, P1, P2, Q = store.load_rectification()
    except (FileNotFoundError, OSError):
        print("need calibration + rectification artifacts first", file=sys.stderr)
        return 2

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    info = video_info(args.left)
    size = (info["width"], info["height"])
    maps = None
    maps_path = store.rectify_dir / "maps.npy"
    if maps_path.exists():
        m = np.load(maps_path)
        if m.shape[1:] == (size[1], size[0]):
            maps = tuple(torch.as_tensor(x, device=dev) for x in m)
    if maps is None:
        mx1, my1 = init_undistort_rectify_map(t64(rig.K1), t64(rig.d1), t64(R1), t64(P1), size)
        mx2, my2 = init_undistort_rectify_map(t64(rig.K2), t64(rig.d2), t64(R2), t64(P2), size)
        maps = (mx1, my1, mx2, my2)

    # Stored flash offset (right = left + offset), as in _synced_rgb_frames.
    sync = store.load_sync()
    offset = int(sync.get("frame_offset", sync.get("offset", 0))) if sync else 0

    if args.device == "cuda":
        mesh = create_mesh(n_data=args.devices, n_space=1)
    else:
        mesh = create_mesh(n_data=args.devices or 1, n_space=1, devices=[dev] * (args.devices or 1))
    n_data = mesh.devices.shape[0]
    # sgbm_hier packs 128 // band frames per device program: 32 for the
    # band-4 headline preset (HIER4_FAST, the default window), 16 for
    # band-8, 8 for band-16 — batched_stereo_pipeline selects the preset
    # by the per-device batch. bm/sgbm keep the smaller 8-frame default
    # window (r4 advice: the 16x default doubled their per-device batch,
    # a 1080p memory/latency change with no hier-related benefit).
    default_window = (32 if args.matcher == "sgbm_hier" else 8) * n_data
    window = args.window or default_window
    # Upfront validation: a bad window otherwise fails deep inside the
    # sharded pipeline (or, for sgbm_hier, as the batch's preset refusal).
    if window % n_data != 0:
        print(
            f"--window {window} must be divisible by the data-axis device "
            f"count {n_data}",
            file=sys.stderr,
        )
        return 2
    if args.matcher == "sgbm_hier" and window // n_data not in (8, 16, 32):
        print(
            f"--window {window}: sgbm_hier packs 32 (band-4 headline), 16 "
            f"(band-8) or 8 (band-16) frames per device — use --window "
            f"{32 * n_data}, {16 * n_data} or {8 * n_data}",
            file=sys.stderr,
        )
        return 2
    if args.matcher == "bm":
        params = StereoBMParams(
            num_disparities=args.num_disparities, block_size=args.block_size
        )
    else:
        params = StereoSGBMParams(
            num_disparities=args.num_disparities, block_size=args.block_size,
            uniqueness_ratio=10,
        )

    out_dir = Path(args.test_dir) / "results" / "stream"
    out_dir.mkdir(parents=True, exist_ok=True)
    video_out = video_path(args.video_out) if args.video_out else None
    sink = VideoSink(video_out, fps=info["fps"] or 30.0) if video_out else None
    per_frame: list[dict] = []
    n_frames = 0
    t_first = None  # end of the FIRST window: excludes the kernels' first build and launch
    n_first = 0
    waits0 = counters()
    t0 = time.perf_counter()
    # Without --video-out the per-frame stats are computed ON DEVICE and
    # only two floats/frame cross the host link (streaming._frame_stats —
    # shipping full disparity+points windows costs ~15 MB per 720p frame
    # and turns the stream transfer-bound on slow device links).
    stats_only = sink is None
    for seq, disp, pts, n_valid in stream_video_pair(
        args.left, args.right, mesh, maps, t64(Q),
        matcher=args.matcher, params=params, window=window,
        left_start=max(0, -offset), right_start=max(0, offset),
        max_frames=args.max_frames, stats_only=stats_only,
    ):
        for k in range(n_valid):
            if stats_only:
                vf, med = float(disp[k, 0]), float(disp[k, 1])
                per_frame.append({
                    "frame": seq * window + k,
                    "valid_fraction": vf,
                    "median_depth_mm": None if np.isnan(med) else med,
                })
                continue
            d = disp[k]
            # d == 0 is excluded (unlike cmd_disparity's d > -1 validity):
            # depth statistics flow through Q, whose Q[3,3] ~ 0 maps
            # disparity 0 to infinite depth — keeping it finite here.
            valid = d > 0
            z = pts[k, ..., 2][valid]
            per_frame.append({
                "frame": seq * window + k,
                "valid_fraction": float(valid.mean()),
                "median_depth_mm": float(np.median(z)) if z.size else None,
            })
            vis = np.zeros_like(d)
            if valid.any():
                vis[valid] = d[valid] / max(float(d[valid].max()), 1e-6) * 255
            sink.append(vis.astype(np.uint8))
        n_frames += int(n_valid)
        if t_first is None:
            t_first = time.perf_counter()
            n_first = n_frames
    dt = time.perf_counter() - t0
    dt_steady = (time.perf_counter() - t_first) if t_first is not None else 0.0
    n_steady = n_frames - n_first
    waits = {k: v - waits0[k] for k, v in counters().items()}

    if sink is not None:
        sink.close()
    stats_path = out_dir / "stream_stats.json"
    with open(stats_path, "w") as f:
        json.dump(per_frame, f, indent=1)
    summary = {
        "stage": "stream",
        "matcher": args.matcher,
        "frames": n_frames,
        "size": list(size),
        "frame_offset": offset,
        "fps": n_frames / dt if dt > 0 else None,
        "fps_steady": n_steady / dt_steady if n_steady and dt_steady > 0 else None,
        "mpx_per_s": n_frames * size[0] * size[1] / dt / 1e6 if dt > 0 else None,
        "note": "fps includes the first window (the kernels' one-time build "
                "and first launch); fps_steady excludes the first window",
        # Whether decode or the card paced the run: the stream waiting on the
        # frame rings for decoded windows, and the decode threads waiting on
        # them for free slots (the stream consuming slower than decode).
        "loader_wait_s": waits["ring.get_wait_ns"] * 1e-9,
        "loader_gets": waits["ring.gets"],
        "ring_put_wait_s": waits["ring.put_wait_ns"] * 1e-9,
        "ring_puts": waits["ring.puts"],
        "stats": str(stats_path),
        **({"video_out": str(video_out)} if video_out else {}),
    }
    print(json.dumps(summary))
    return 0 if n_frames else 2


def _synced_rgb_frames(store, left_path, right_path, max_frames):
    """Synchronized RGB frame stacks using the stored flash offset
    (right = left + offset, sync/mapper convention; reference 3dpose.py
    and ball_drop.py consume sync_data.pkl the same way)."""
    from stereo_vision_tpu_torch.io.video import extract_frames

    sync = store.load_sync()
    # ArtifactStore.save_sync persists the key as "frame_offset"
    # (sync_data.pkl schema, ball_drop.py:22-34).
    offset = int(sync.get("frame_offset", sync.get("offset", 0))) if sync else 0
    lf, _ = extract_frames(
        left_path, start=max(0, -offset), interval=1, max_frames=max_frames
    )
    rf, _ = extract_frames(
        right_path, start=max(0, offset), interval=1, max_frames=max_frames
    )
    T = min(len(lf), len(rf))
    return lf[:T], rf[:T], offset


def cmd_pose(args) -> int:
    """Flagship stereo 3D pose workflow (reference 3dpose.py)."""
    from stereo_vision_tpu_torch.models.pretrained import pose_landmarks_in_frames
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.track.pose_pipeline import run_pose_workflow

    store = ArtifactStore(args.test_dir)
    try:
        rig = store.load_rig()
    except FileNotFoundError:
        print("no calibration artifacts; run intrinsic+extrinsic first", file=sys.stderr)
        return 2
    lf, rf, offset = _synced_rgb_frames(store, args.left, args.right, args.max_frames)
    if len(lf) == 0:
        print("no frames decoded", file=sys.stderr)
        return 2
    dev = _device(args)
    ll = pose_landmarks_in_frames(lf, device=dev)
    rl = pose_landmarks_in_frames(rf, device=dev)
    out = Path(args.test_dir) / "results" / "pose"
    res = run_pose_workflow(
        rig, ll, rl, smoothing_preset=args.preset, out_dir=out, fps=args.fps, device=dev
    )
    print(
        json.dumps(
            {
                "stage": "pose",
                "frames": int(len(lf)),
                "sync_offset": offset,
                "valid_pose_fraction": float(
                    np.isfinite(res.poses_smoothed).all(-1).mean()
                ),
                "smoothing_stats": res.smoothing_stats,
                "output": str(out),
            }
        )
    )
    return 0


def cmd_ball_drop(args) -> int:
    """Stereo ball-drop physics validation (reference ball_drop.py)."""
    from stereo_vision_tpu_torch.models.pretrained import detect_balls_in_frames
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.track.ball import analyze_ball_drop, drop_report

    store = ArtifactStore(args.test_dir)
    try:
        rig = store.load_rig()
    except FileNotFoundError:
        print("no calibration artifacts; run intrinsic+extrinsic first", file=sys.stderr)
        return 2
    lf, rf, offset = _synced_rgb_frames(store, args.left, args.right, args.max_frames)
    if len(lf) == 0:
        print("no frames decoded", file=sys.stderr)
        return 2
    dev = _device(args)
    ld = detect_balls_in_frames(lf, score_threshold=args.score_threshold, device=dev)
    rd = detect_balls_in_frames(rf, score_threshold=args.score_threshold, device=dev)
    traj = analyze_ball_drop(rig, ld, rd, fps=args.fps, drop_height_mm=args.drop_height, device=dev)
    report = drop_report(traj, drop_height_mm=args.drop_height)
    out = Path(args.test_dir) / "results" / "ball_drop"
    out.mkdir(parents=True, exist_ok=True)
    if args.animate:
        # Two-pane growing-path animation (reference ball_motion.py:578-648).
        from stereo_vision_tpu_torch.pipeline.animations import create_rolling_animation

        def centers(dets):
            xy = np.full((len(dets), 2), np.nan)
            for i, d in enumerate(dets):
                if d is not None:
                    xy[i] = (d.cx, d.cy)
            return xy

        ts = np.arange(len(ld)) / args.fps
        written = create_rolling_animation(
            centers(ld), centers(rd), ts, out / "ball_motion.mp4"
        )
        report["animation"] = str(written)
    # Written after --animate so the artifact records the animation path.
    (out / "drop_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({"stage": "ball_drop", "sync_offset": offset, **report}))
    return 0


def _load_pose_pickle(path) -> np.ndarray:
    """(T, J, 3) poses from either this framework's bare-array pickles or
    the reference's dict schema ({'poses', 'angles', 'timestamps', 'fps'},
    3dpose.py:935-965) — reference users bring those files directly."""
    import pickle

    with open(path, "rb") as f:
        data = pickle.load(f)
    if isinstance(data, dict):
        data = data["poses"]
    return np.asarray(data, np.float64)


def cmd_smooth(args) -> int:
    """Re-smooth a saved pose sequence + regression metrics (reference
    motion_smoothing.py + test_smoothing.py)."""
    import pickle

    from stereo_vision_tpu_torch.pipeline.reporting import smoothing_comparison_stats
    from stereo_vision_tpu_torch.track.smoothing import MotionSmoother

    dev = _device(args)
    poses = _load_pose_pickle(args.input)
    smoother = MotionSmoother(args.preset, device=dev)
    smoothed = smoother.smooth_pose_sequence(poses)
    stats = smoothing_comparison_stats(poses, smoothed, device=dev)
    out = Path(args.out or Path(args.input).parent / "pose_3d_resmoothed.pkl")
    with open(out, "wb") as f:
        pickle.dump(smoothed, f)
    print(json.dumps({"stage": "smooth", "preset": args.preset, **stats, "output": str(out)}))
    return 0


def cmd_animate(args) -> int:
    """Side-by-side raw-vs-smoothed 3D skeleton animation (reference
    visualize_smoothing.py:58-197)."""
    from stereo_vision_tpu_torch.pipeline.animations import create_pose_comparison_video

    raw = _load_pose_pickle(args.raw)
    smoothed = _load_pose_pickle(args.smoothed)
    out = create_pose_comparison_video(
        raw, smoothed, args.out, fps=args.fps, duration=args.duration
    )
    print(json.dumps({"stage": "animate", "frames": int(len(raw)), "output": str(out)}))
    return 0


def _first_gray_frame(path: str) -> np.ndarray:
    """First grayscale frame of a video, or a PNG image read as gray (a
    JPEG or BMP image raises IOError: the port reads PNG only)."""
    from stereo_vision_tpu_torch.io.png import read_png

    p = Path(path)
    if p.suffix.lower() == ".png":
        return read_png(p, grayscale=True)
    if p.suffix.lower() in (".jpg", ".jpeg", ".bmp"):
        raise IOError(f"could not read image: {p} (the port reads PNG images only)")
    from stereo_vision_tpu_torch.io.video import extract_frames

    frames, _ = extract_frames(p, start=0, interval=1, max_frames=1, grayscale=True)
    if len(frames) == 0:
        raise IOError(f"no frames decoded from {p}")
    return frames[0]


def cmd_validate_distance(args) -> int:
    """Checkerboard distance validation (reference checkerboard_distance.py:
    undistortPoints with the rectified R/P -> triangulate -> distance to
    the board center vs the known distance), writing the validation JSON
    that `analyze` aggregates."""
    from stereo_vision_tpu_torch.detect.checkerboard import find_chessboard_corners
    from stereo_vision_tpu_torch.ops.distortion import undistort_points
    from stereo_vision_tpu_torch.ops.triangulate import triangulate_points
    from stereo_vision_tpu_torch.pipeline.aggregation import save_run_results
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.track.validators import validate_distance

    store = ArtifactStore(args.test_dir)
    try:
        rig = store.load_rig()
        R1, R2, P1, P2, _ = store.load_rectification()
    except (FileNotFoundError, OSError):
        print("need calibration + rectification artifacts first", file=sys.stderr)
        return 2
    dev = _device(args)
    board = _parse_pair(args.board)
    corners = {}
    for side, path in (("left", args.left), ("right", args.right)):
        ok, c = find_chessboard_corners(_first_gray_frame(path), board, backend="auto", device=dev)
        if not ok:
            print(f"no checkerboard found in {side} view", file=sys.stderr)
            return 2
        corners[side] = np.asarray(c).reshape(-1, 2)
    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    ul = undistort_points(t64(corners["left"]), t64(rig.K1), t64(rig.d1), R=t64(R1), P=t64(P1))
    ur = undistort_points(t64(corners["right"]), t64(rig.K2), t64(rig.d2), R=t64(R2), P=t64(P2))
    pts3d = triangulate_points(t64(P1)[:3, :4], t64(P2)[:3, :4], ul, ur).cpu().numpy()
    res = validate_distance(pts3d, args.actual_distance, args.tolerance)
    out_dir = Path(args.test_dir) / "results"
    name = args.name or f"distance_{int(args.actual_distance)}"
    save_run_results([res], out_dir / f"{name}_validation.json", source=name)
    print(json.dumps({"stage": "validate_distance", **res._asdict()}))
    return 0 if res.passed else 1


def cmd_measure(args) -> int:
    """Click-to-measure replay (reference calibrate_v4/distance.py:227-486
    DistanceMeasurementTool, headless: clicks come from a JSON file; see
    pipeline/measure.py for the schema and the matplotlib picker)."""
    from stereo_vision_tpu_torch.pipeline.artifacts import ArtifactStore
    from stereo_vision_tpu_torch.pipeline.measure import load_clicks, measure_clicks

    store = ArtifactStore(args.test_dir)
    try:
        rig = store.load_rig()
    except (FileNotFoundError, OSError):
        print("need calibration artifacts first", file=sys.stderr)
        return 2
    clicks = load_clicks(args.clicks)
    if args.rectified:
        R1, R2, P1, P2, _ = store.load_rectification()
        reports = measure_clicks(
            clicks, rig.K1, rig.d1, rig.K2, rig.d2, P1, P2,
            R1=R1, R2=R2, tolerance_percent=args.tolerance, device=_device(args),
        )
    else:
        P1 = np.asarray(rig.K1) @ np.hstack([np.eye(3), np.zeros((3, 1))])
        P2 = np.asarray(rig.K2) @ np.hstack(
            [np.asarray(rig.R), np.asarray(rig.T).reshape(3, 1)]
        )
        reports = measure_clicks(
            clicks, rig.K1, rig.d1, rig.K2, rig.d2, P1, P2,
            tolerance_percent=args.tolerance, device=_device(args),
        )
    out = {"stage": "measure", "measurements": [r.to_dict() for r in reports]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    ok = all(r.validation is None or r.validation.passed for r in reports)
    return 0 if ok else 1


def cmd_analyze(args) -> int:
    """Cross-run validation aggregation (reference analyze_validation.py)."""
    from stereo_vision_tpu_torch.pipeline.aggregation import (
        collect_run_results,
        generate_validation_report,
        overall_metrics,
    )

    results = collect_run_results(args.results_dir)
    if not results:
        print("no validation records found", file=sys.stderr)
        return 2
    out = generate_validation_report(results, args.out or args.results_dir)
    print(
        json.dumps(
            {
                "stage": "analyze",
                "runs": len(results),
                **(overall_metrics(results) or {}),
                "report": str(out),
            }
        )
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="stereo_vision_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def command(*a, **kw):
        sp = sub.add_parser(*a, **kw)
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the card, the default) or cpu (the plain forms)")
        return sp

    def add_frame_args(sp):
        # reference sampling defaults (intrinsic.py:452-467)
        sp.add_argument("--frame-interval", type=int, default=15)
        sp.add_argument("--max-frames", type=int, default=20)
        sp.add_argument("--start-frame", type=int, default=30)
        sp.add_argument("--skip-existing", action="store_true",
                        help="skip when output artifacts exist (v4 runner)")

    pi = command("intrinsic", help="per-camera calibration")
    pi.add_argument("--test-dir", required=True)
    pi.add_argument("--board", default="7x4", help="inner corners, e.g. 7x4")
    pi.add_argument("--square", type=float, default=100.0, help="square size mm")
    add_frame_args(pi)
    pi.set_defaults(fn=cmd_intrinsic)

    pe = command("extrinsic", help="stereo calibration")
    pe.add_argument("--test-dir", required=True)
    pe.add_argument("--board", default="7x4")
    pe.add_argument("--square", type=float, default=100.0)
    pe.add_argument("--actual-distance", type=float, default=None)
    add_frame_args(pe)
    pe.set_defaults(fn=cmd_extrinsic)

    pr = command("rectify", help="Bouguet rectification maps")
    pr.add_argument("--test-dir", required=True)
    pr.add_argument("--size", default="1920x1080")
    pr.set_defaults(fn=cmd_rectify)

    ps = command("sync", help="flash synchronization")
    ps.add_argument("--test-dir", required=True)
    ps.add_argument("--left", required=True)
    ps.add_argument("--right", required=True)
    ps.add_argument("--max-frames", type=int, default=900)
    ps.set_defaults(fn=cmd_sync)

    pd = command("disparity", help="dense disparity on an image pair")
    pd.add_argument("--test-dir", required=True)
    pd.add_argument("--left", required=True)
    pd.add_argument("--right", required=True)
    pd.add_argument("--matcher", choices=("bm", "sgbm"), default="sgbm")
    pd.add_argument("--num-disparities", type=int, default=64)
    pd.add_argument("--block-size", type=int, default=5)
    pd.set_defaults(fn=cmd_disparity)

    pst = command(
        "stream", help="streaming video -> disparity/depth (BASELINE config #5)"
    )
    pst.add_argument("--test-dir", required=True)
    pst.add_argument("--left", required=True)
    pst.add_argument("--right", required=True)
    pst.add_argument(
        "--matcher", choices=("bm", "sgbm", "sgbm_hier"), default="sgbm_hier"
    )
    pst.add_argument("--num-disparities", type=int, default=128)
    pst.add_argument("--block-size", type=int, default=5)
    pst.add_argument("--devices", type=int, default=None,
                     help="data-axis device count (default: all)")
    pst.add_argument("--window", type=int, default=None,
                     help="frames per device program (default: matcher pack size x data-axis devices)")
    pst.add_argument("--max-frames", type=int, default=None)
    pst.add_argument("--video-out", default=None,
                     help="write a disparity-visualization video (raw AVI under the same "
                          "stem where the name needs ffmpeg and it is not on PATH)")
    pst.set_defaults(fn=cmd_stream)

    pp = command("pose", help="stereo 3D pose workflow (flagship)")
    pp.add_argument("--test-dir", required=True)
    pp.add_argument("--left", required=True)
    pp.add_argument("--right", required=True)
    pp.add_argument("--preset", default="smalliphone")
    pp.add_argument("--fps", type=float, default=30.0)
    pp.add_argument("--max-frames", type=int, default=900)
    pp.set_defaults(fn=cmd_pose)

    pbd = command("ball-drop", help="ball-drop physics validation")
    pbd.add_argument("--test-dir", required=True)
    pbd.add_argument("--left", required=True)
    pbd.add_argument("--right", required=True)
    pbd.add_argument("--fps", type=float, default=30.0)
    pbd.add_argument("--drop-height", type=float, default=None, help="mm")
    pbd.add_argument("--score-threshold", type=float, default=0.3)
    pbd.add_argument("--max-frames", type=int, default=900)
    pbd.add_argument("--animate", action="store_true",
                     help="write the two-pane ball-motion animation")
    pbd.set_defaults(fn=cmd_ball_drop)

    psm = command("smooth", help="re-smooth a saved pose pickle")
    psm.add_argument("--input", required=True, help="(T, J, 3) pose pickle")
    psm.add_argument("--preset", default="smalliphone")
    psm.add_argument("--out", default=None)
    psm.set_defaults(fn=cmd_smooth)

    pan = command("animate", help="raw-vs-smoothed skeleton video")
    pan.add_argument("--raw", required=True)
    pan.add_argument("--smoothed", required=True)
    pan.add_argument("--out", required=True)
    pan.add_argument("--fps", type=float, default=10.0)
    pan.add_argument("--duration", type=float, default=10.0)
    pan.set_defaults(fn=cmd_animate)

    pvd = command(
        "validate-distance", help="checkerboard distance validation"
    )
    pvd.add_argument("--test-dir", required=True)
    pvd.add_argument("--left", required=True, help="image or video")
    pvd.add_argument("--right", required=True)
    pvd.add_argument("--actual-distance", type=float, required=True, help="mm")
    pvd.add_argument("--board", default="7x4")
    pvd.add_argument("--tolerance", type=float, default=10.0, help="percent")
    pvd.add_argument("--name", default=None, help="run name for analyze")
    pvd.set_defaults(fn=cmd_validate_distance)

    paz = command("analyze", help="cross-run validation aggregation")
    paz.add_argument("--results-dir", required=True)
    paz.add_argument("--out", default=None)
    paz.set_defaults(fn=cmd_analyze)

    pm = command(
        "measure", help="click-to-measure replay (point pairs -> 3D distances)"
    )
    pm.add_argument("--test-dir", required=True)
    pm.add_argument("--clicks", required=True, help="clicks JSON (pipeline.measure schema)")
    pm.add_argument("--rectified", action="store_true",
                    help="clicks are in rectified-frame pixels")
    pm.add_argument("--tolerance", type=float, default=10.0, help="percent")
    pm.add_argument("--out", default=None, help="results JSON path")
    pm.set_defaults(fn=cmd_measure)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
