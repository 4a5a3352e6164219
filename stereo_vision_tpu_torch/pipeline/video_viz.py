"""Video overlay renderers.

Port of ``stereo_vision_tpu/pipeline/video_viz.py``. The reference writes
mp4 visualizations: side-by-side skeleton animations (reference:
visualize_smoothing.py:58-197), ball-trajectory animations
(ball_drop.py:582-781, ball_motion.py:578-648) and annotated pose frames
(3dpose.py:438-453). These render the same overlays on numpy frames
(host-side by design) with ``pipeline.drawing``'s OpenCV-free lines and
circles, and write them with ``io.video`` (:func:`.animations.video_path`:
an ``.mp4`` name where ffmpeg is on PATH, else raw AVI under the same
stem).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stereo_vision_tpu_torch.pipeline.drawing import draw_circle, draw_line
from stereo_vision_tpu_torch.track.joints import JOINT_INDEX

# Skeleton edges over the 13 key joints.
SKELETON_EDGES: tuple[tuple[str, str], ...] = (
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


def draw_skeleton_2d(
    frame: np.ndarray,
    joints_px: np.ndarray,
    color: tuple[int, int, int] = (0, 255, 0),
    radius: int = 4,
) -> np.ndarray:
    """Draw a 13-joint skeleton onto an RGB frame (in place; returns it).

    Args:
      joints_px: (13, 2) pixel coordinates, NaN rows skipped.
    """
    for a, b in SKELETON_EDGES:
        pa = joints_px[JOINT_INDEX[a]]
        pb = joints_px[JOINT_INDEX[b]]
        if np.isfinite(pa).all() and np.isfinite(pb).all():
            draw_line(frame, tuple(pa.astype(int)), tuple(pb.astype(int)), color, 2)
    for p in joints_px:
        if np.isfinite(p).all():
            draw_circle(frame, tuple(p.astype(int)), radius, (255, 0, 0), -1)
    return frame


def render_skeleton_video(
    frames: np.ndarray,
    joints_px: np.ndarray,
    out_path: str | Path,
    fps: float = 30.0,
    smoothed_px: np.ndarray | None = None,
) -> Path:
    """Annotated skeleton video; optional smoothed overlay in a second
    color (visualize_smoothing.py side-by-side semantics, single pane).

    Args:
      frames: (T, H, W, 3) RGB uint8.
      joints_px: (T, 13, 2) raw joint pixels.
      smoothed_px: optional (T, 13, 2) smoothed joints drawn in orange.

    Returns the path written (:func:`.animations.video_path`).
    """
    from stereo_vision_tpu_torch.io.video import write_video
    from stereo_vision_tpu_torch.pipeline.animations import video_path

    out = []
    for t, f in enumerate(np.asarray(frames)):
        img = f.copy()
        draw_skeleton_2d(img, joints_px[t], color=(0, 255, 0))
        if smoothed_px is not None:
            draw_skeleton_2d(img, smoothed_px[t], color=(255, 165, 0), radius=3)
        out.append(img)
    return write_video(video_path(out_path), np.stack(out), fps=fps)


def render_ball_video(
    frames: np.ndarray,
    centers_px: np.ndarray,
    radii_px: np.ndarray,
    out_path: str | Path,
    fps: float = 30.0,
    trail: int = 12,
) -> Path:
    """Ball detection + fading trajectory trail (ball_drop.py:582-781).

    Args:
      frames: (T, H, W, 3) RGB uint8.
      centers_px: (T, 2) detected centers (NaN = missed frame).
      radii_px: (T,) radii.

    Returns the path written (:func:`.animations.video_path`).
    """
    from stereo_vision_tpu_torch.io.video import write_video
    from stereo_vision_tpu_torch.pipeline.animations import video_path

    out = []
    centers = np.asarray(centers_px)
    for t, f in enumerate(np.asarray(frames)):
        img = f.copy()
        for k in range(max(0, t - trail), t):
            a, b = centers[k], centers[min(k + 1, t)]
            if np.isfinite(a).all() and np.isfinite(b).all():
                draw_line(img, tuple(a.astype(int)), tuple(b.astype(int)), (255, 255, 0), 1)
        c = centers[t]
        if np.isfinite(c).all():
            draw_circle(img, tuple(c.astype(int)), max(int(radii_px[t]), 2), (0, 255, 0), 2)
        out.append(img)
    return write_video(video_path(out_path), np.stack(out), fps=fps)
