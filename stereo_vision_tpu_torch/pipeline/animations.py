"""Animated comparison renderers (reference renderer tail).

Port of ``stereo_vision_tpu/pipeline/animations.py``. It rebuilds the three
mp4/png artifact generators the reference ships:

- side-by-side 3D skeleton comparison video, original vs smoothed
  (reference: visualize_smoothing.py:58-197 — two 3D subplots, per-frame
  bounding-box axis limits with 100 mm margin, frames sampled to
  fps*duration, frame number in each title),
- rolling-ball two-camera animation (reference: ball_motion.py:578-648 —
  growing trajectory path + current ball marker per camera, inverted
  pixel y-axis, time annotation),
- synchronized-pair snapshots (reference: flash_sync.py:346-394 —
  hstacked left/right frames with frame-number labels) and the
  human-readable sync report (flash_sync.py:677-694).

Animations render each sampled frame to an RGB array (matplotlib's Agg
canvas, imported when they run: ``ImportError`` naming it where it is not
installed) and encode through ``io.video.write_video``: an ``.mp4`` (or
other ffmpeg container) path stays as named where ffmpeg is on PATH, and is
written as raw AVI under the same stem where it is not
(:func:`video_path`); each function returns the path it wrote. The
snapshots are drawn without OpenCV (``pipeline.drawing``: its resize, its
Hershey text) and written by ``io.png``.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from stereo_vision_tpu_torch.io.png import write_png
from stereo_vision_tpu_torch.pipeline.drawing import put_text, resize_linear
from stereo_vision_tpu_torch.pipeline.reporting import pyplot
from stereo_vision_tpu_torch.track.joints import JOINT_INDEX

_BONES: tuple[tuple[str, str], ...] = (
    ("nose", "left_shoulder"),
    ("nose", "right_shoulder"),
    ("left_shoulder", "right_shoulder"),
    ("left_shoulder", "left_elbow"),
    ("left_elbow", "left_wrist"),
    ("right_shoulder", "right_elbow"),
    ("right_elbow", "right_wrist"),
    ("left_shoulder", "left_hip"),
    ("right_shoulder", "right_hip"),
    ("left_hip", "right_hip"),
    ("left_hip", "left_knee"),
    ("left_knee", "left_ankle"),
    ("right_hip", "right_knee"),
    ("right_knee", "right_ankle"),
)


def video_path(path: str | Path) -> Path:
    """The path a video asked for at ``path`` is written to: itself for an
    ``.avi`` name or where ffmpeg is on PATH (``io.video`` encodes other
    containers through it), else the same stem with ``.avi`` (raw AVI,
    which needs no encoder)."""
    path = Path(path)
    if path.suffix.lower() == ".avi" or shutil.which("ffmpeg") is not None:
        return path
    return path.with_suffix(".avi")


def _draw_skeleton_3d(ax, pose: np.ndarray, color: str) -> None:
    """(13, 3) pose onto a 3D axis; NaN joints skipped."""
    for a, b in _BONES:
        pa, pb = pose[JOINT_INDEX[a]], pose[JOINT_INDEX[b]]
        if np.isfinite(pa).all() and np.isfinite(pb).all():
            ax.plot([pa[0], pb[0]], [pa[1], pb[1]], [pa[2], pb[2]], color=color, alpha=0.85)
    ok = np.isfinite(pose).all(axis=1)
    if ok.any():
        ax.scatter(pose[ok, 0], pose[ok, 1], pose[ok, 2], c=color, s=14, alpha=0.85)


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def _sample_indices(total: int, fps: float, duration: float) -> np.ndarray:
    count = max(int(fps * duration), 1)  # fps*duration < 1 -> one frame
    if count >= total:
        return np.arange(total)
    return np.linspace(0, total - 1, count).astype(int)


def create_pose_comparison_video(
    poses_raw: np.ndarray,
    poses_smoothed: np.ndarray,
    out_path: str | Path,
    fps: float = 10.0,
    duration: float = 10.0,
    timestamps: np.ndarray | None = None,
) -> Path:
    """Side-by-side original-vs-smoothed 3D skeleton animation.

    Args:
      poses_raw, poses_smoothed: (T, 13, 3) mm pose sequences.
      fps, duration: output rate and target length; frames are sampled
        evenly when T exceeds fps*duration (reference semantics).

    Returns the path written (:func:`video_path`).
    """
    from stereo_vision_tpu_torch.io.video import write_video

    plt = pyplot()

    T = min(len(poses_raw), len(poses_smoothed))
    idx = _sample_indices(T, fps, duration)
    frames = []
    fig = plt.figure(figsize=(12, 6))
    ax1 = fig.add_subplot(121, projection="3d")
    ax2 = fig.add_subplot(122, projection="3d")
    for t in idx:
        for ax, pose, color, title in (
            (ax1, poses_raw[t], "r", f"Original Pose (Frame {t})"),
            (ax2, poses_smoothed[t], "b", f"Smoothed Pose (Frame {t})"),
        ):
            ax.clear()
            ax.set_title(title)
            ax.set_xlabel("X")
            ax.set_ylabel("Y")
            ax.set_zlabel("Z")
        pts = np.concatenate([poses_raw[t], poses_smoothed[t]])
        pts = pts[np.isfinite(pts).all(axis=1)]
        if len(pts):
            lo, hi = pts.min(0) - 100.0, pts.max(0) + 100.0
        else:
            lo, hi = np.full(3, -500.0), np.full(3, 500.0)
        for ax in (ax1, ax2):
            ax.set_xlim(lo[0], hi[0])
            ax.set_ylim(lo[1], hi[1])
            ax.set_zlim(lo[2], hi[2])
        _draw_skeleton_3d(ax1, np.asarray(poses_raw[t]), "r")
        _draw_skeleton_3d(ax2, np.asarray(poses_smoothed[t]), "b")
        if timestamps is not None:
            fig.suptitle(f"Time: {timestamps[t]:.2f}s", fontsize=13)
        frames.append(_fig_to_rgb(fig))
    plt.close(fig)
    return write_video(video_path(out_path), np.stack(frames), fps=fps)


def create_rolling_animation(
    left_xy: np.ndarray,
    right_xy: np.ndarray,
    timestamps: np.ndarray,
    out_path: str | Path,
    fps: float = 20.0,
    max_frames: int = 200,
) -> Path:
    """Two-pane growing-path ball animation (ball_motion.py:578-648).

    Args:
      left_xy, right_xy: (T, 2) pixel ball centers per camera (NaN = miss).
      timestamps: (T,) seconds, shown as the time annotation.

    Returns the path written (:func:`video_path`).
    """
    from stereo_vision_tpu_torch.io.video import write_video

    plt = pyplot()

    T = min(len(left_xy), len(right_xy), len(timestamps))
    idx = _sample_indices(T, max_frames, 1.0)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 6))
    for ax, xy, title in ((ax1, left_xy, "Ball Motion (Left Camera)"),
                          (ax2, right_xy, "Ball Motion (Right Camera)")):
        finite = np.asarray(xy)[np.isfinite(xy).all(axis=1)]
        if len(finite) == 0:
            finite = np.zeros((1, 2))
        padx = max((finite[:, 0].max() - finite[:, 0].min()) * 0.1, 1.0)
        pady = max((finite[:, 1].max() - finite[:, 1].min()) * 0.1, 1.0)
        ax.set_xlim(finite[:, 0].min() - padx, finite[:, 0].max() + padx)
        # pixel y grows downward: inverted axis, like the reference
        ax.set_ylim(finite[:, 1].max() + pady, finite[:, 1].min() - pady)
        ax.set_xlabel("X Position (pixels)")
        ax.set_ylabel("Y Position (pixels)")
        ax.set_title(title)
        ax.grid(True)
    (ball_l,) = ax1.plot([], [], "ro", ms=10)
    (path_l,) = ax1.plot([], [], "b-", alpha=0.7)
    (ball_r,) = ax2.plot([], [], "ro", ms=10)
    (path_r,) = ax2.plot([], [], "b-", alpha=0.7)
    time_text = fig.text(0.5, 0.95, "", ha="center")

    frames = []
    for t in idx:
        for ball, path, xy in ((ball_l, path_l, left_xy), (ball_r, path_r, right_xy)):
            hist = np.asarray(xy[: t + 1])
            hist = hist[np.isfinite(hist).all(axis=1)]
            path.set_data(hist[:, 0], hist[:, 1])
            cur = np.asarray(xy[t])
            if np.isfinite(cur).all():
                ball.set_data([cur[0]], [cur[1]])
        time_text.set_text(f"Time: {timestamps[t]:.2f} s")
        frames.append(_fig_to_rgb(fig))
    plt.close(fig)
    return write_video(video_path(out_path), np.stack(frames), fps=fps)


def save_sync_visualizations(
    left_frames: np.ndarray,
    right_frames: np.ndarray,
    matched_pairs: list[tuple[int, int]],
    out_dir: str | Path,
    sample_count: int = 5,
) -> list[Path]:
    """Side-by-side synchronized-pair snapshots (flash_sync.py:346-394).

    The reference writes the (RGB) frames through ``cv2.imwrite``, which
    takes them for BGR; the port writes the same bytes (a colour frame's
    red and blue channels trade places in the file, as the reference's)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = min(len(matched_pairs), len(left_frames), len(right_frames), sample_count)
    paths = []
    for i in range(n):
        li, ri = matched_pairs[i]
        lf = np.asarray(left_frames[i])
        rf = np.asarray(right_frames[i])
        if lf.ndim == 2:
            lf = np.stack([lf] * 3, -1)
        if rf.ndim == 2:
            rf = np.stack([rf] * 3, -1)
        if lf.shape[0] != rf.shape[0]:
            scale = lf.shape[0] / rf.shape[0]
            rf = resize_linear(rf, int(rf.shape[1] * scale), lf.shape[0])
        combined = np.ascontiguousarray(np.hstack([lf, rf]).astype(np.uint8))
        put_text(combined, f"Left: {li}", (10, 30), 1, (0, 255, 0), 2)
        put_text(combined, f"Right: {ri}", (lf.shape[1] + 10, 30), 1, (0, 255, 0), 2)
        p = out / f"sync_visualization_{i:02d}.png"
        write_png(p, combined[..., ::-1])
        paths.append(p)
    return paths


def write_sync_report(sync_info: dict, out_path: str | Path) -> Path:
    """Human-readable synchronization report (flash_sync.py:677-694)."""
    import time as _time

    offset = sync_info.get("frame_offset", 0)
    lines = [
        "Video Synchronization Report",
        "==========================",
        "",
        f"Date: {_time.strftime('%Y-%m-%d %H:%M:%S')}",
        f"Left video: {sync_info.get('left_video', '?')}",
        f"Right video: {sync_info.get('right_video', '?')}",
        "",
        f"Synchronization method: {sync_info.get('method', 'flash_detection')}",
        f"  Left flash frame: {sync_info.get('left_flash_frame')}",
        f"  Right flash frame: {sync_info.get('right_flash_frame')}",
        f"  Frame offset (right - left): {offset}",
        "",
        "Video properties:",
        f"  Left: {sync_info.get('left_fps', 0):.2f} fps, "
        f"{sync_info.get('left_frame_count', '?')} frames",
        f"  Right: {sync_info.get('right_fps', 0):.2f} fps, "
        f"{sync_info.get('right_frame_count', '?')} frames",
        "",
        "Usage instructions:",
        "  To get the right frame corresponding to left frame X:",
        f"    right_frame = X + {offset}",
        "",
        "  To get the left frame corresponding to right frame Y:",
        f"    left_frame = Y - {offset}",
        "",
    ]
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("\n".join(lines))
    return p
