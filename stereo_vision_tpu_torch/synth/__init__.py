"""Synthetic scenes: the benchmark's stereo pairs, and the renders and
training batches of the ball and pose detectors (OpenCV-free)."""

from stereo_vision_tpu_torch.synth.scenes import (
    ball_training_batch,
    body33_from_key13,
    pose_training_batch,
    render_ball_drop_stereo,
    render_pose_stereo,
    stick_figure_frame,
    textured_background,
)

__all__ = [
    "ball_training_batch",
    "body33_from_key13",
    "pose_training_batch",
    "render_ball_drop_stereo",
    "render_pose_stereo",
    "stick_figure_frame",
    "textured_background",
]
