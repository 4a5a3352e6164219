"""Canonical joint set, limb topology and anthropometry.

The port's own copy of ``stereo_vision_tpu/track/joints.py`` (numpy
tables and helpers, unchanged). The reference tracks 13 key joints out of
MediaPipe's 33 landmarks (reference: stereo_calibration/scripts/3dpose.py:503-518) and constrains
12 limb pairs (motion_smoothing.py:500-512) with a default anthropometry
table (motion_smoothing.py:585-600).

Poses here are dense arrays ``(T, J, 3)`` (mm) with NaN marking missing
joints — the dict-of-arrays representation of the reference becomes a
batch axis so every constraint/filter runs over whole tensors.
"""

from __future__ import annotations

import numpy as np

# 13 key joints and their MediaPipe landmark indices (3dpose.py:503-518).
KEY_JOINTS: dict[str, int] = {
    "nose": 0,
    "left_shoulder": 11,
    "right_shoulder": 12,
    "left_elbow": 13,
    "right_elbow": 14,
    "left_wrist": 15,
    "right_wrist": 16,
    "left_hip": 23,
    "right_hip": 24,
    "left_knee": 25,
    "right_knee": 26,
    "left_ankle": 27,
    "right_ankle": 28,
}

JOINT_NAMES: tuple[str, ...] = tuple(KEY_JOINTS.keys())
JOINT_INDEX: dict[str, int] = {n: i for i, n in enumerate(JOINT_NAMES)}
NUM_JOINTS: int = len(JOINT_NAMES)
MEDIAPIPE_INDICES = np.array(list(KEY_JOINTS.values()), dtype=np.int32)

# 12 limb pairs used by the smoother's anatomical constraints
# (motion_smoothing.py:500-512). Order matters: constraints are applied
# sequentially in this order, as in the reference.
LIMB_PAIRS: tuple[tuple[str, str], ...] = (
    ("left_shoulder", "left_elbow"),
    ("left_elbow", "left_wrist"),
    ("right_shoulder", "right_elbow"),
    ("right_elbow", "right_wrist"),
    ("left_hip", "left_knee"),
    ("left_knee", "left_ankle"),
    ("right_hip", "right_knee"),
    ("right_knee", "right_ankle"),
    ("left_shoulder", "right_shoulder"),
    ("left_hip", "right_hip"),
    ("left_shoulder", "left_hip"),
    ("right_shoulder", "right_hip"),
)

# The per-frame constraint set in the pose estimator drops the torso
# diagonals (3dpose.py:760-771).
POSE_LIMB_PAIRS: tuple[tuple[str, str], ...] = LIMB_PAIRS[:10]

LIMB_PAIR_INDICES = np.array(
    [(JOINT_INDEX[a], JOINT_INDEX[b]) for a, b in LIMB_PAIRS], dtype=np.int32
)

# Default anthropometric limb lengths in mm (motion_smoothing.py:585-600).
DEFAULT_LIMB_LENGTHS_MM: dict[tuple[str, str], float] = {
    ("left_shoulder", "left_elbow"): 300.0,
    ("left_elbow", "left_wrist"): 250.0,
    ("right_shoulder", "right_elbow"): 300.0,
    ("right_elbow", "right_wrist"): 250.0,
    ("left_hip", "left_knee"): 400.0,
    ("left_knee", "left_ankle"): 380.0,
    ("right_hip", "right_knee"): 400.0,
    ("right_knee", "right_ankle"): 380.0,
    ("left_shoulder", "right_shoulder"): 350.0,
    ("left_hip", "right_hip"): 250.0,
    ("left_shoulder", "left_hip"): 450.0,
    ("right_shoulder", "right_hip"): 450.0,
}

DEFAULT_LIMB_LENGTH_VEC = np.array(
    [DEFAULT_LIMB_LENGTHS_MM[p] for p in LIMB_PAIRS], dtype=np.float64
)

# The 8 joint angles the reference reports, as (a, vertex, c) triples
# (3dpose.py:808-869).
ANGLE_TRIPLES: dict[str, tuple[str, str, str]] = {
    "right_shoulder": ("right_hip", "right_shoulder", "right_elbow"),
    "left_shoulder": ("left_hip", "left_shoulder", "left_elbow"),
    "right_elbow": ("right_shoulder", "right_elbow", "right_wrist"),
    "left_elbow": ("left_shoulder", "left_elbow", "left_wrist"),
    "right_hip": ("right_shoulder", "right_hip", "right_knee"),
    "left_hip": ("left_shoulder", "left_hip", "left_knee"),
    "right_knee": ("right_hip", "right_knee", "right_ankle"),
    "left_knee": ("left_hip", "left_knee", "left_ankle"),
}

ANGLE_NAMES: tuple[str, ...] = tuple(ANGLE_TRIPLES.keys())
ANGLE_TRIPLE_INDICES = np.array(
    [
        (JOINT_INDEX[a], JOINT_INDEX[b], JOINT_INDEX[c])
        for a, b, c in ANGLE_TRIPLES.values()
    ],
    dtype=np.int32,
)


def pose_dict_to_array(pose: dict[str, np.ndarray]) -> np.ndarray:
    """Reference-style {joint: (3,)} dict -> (J, 3) array with NaN gaps."""
    out = np.full((NUM_JOINTS, 3), np.nan)
    for name, idx in JOINT_INDEX.items():
        if name in pose and pose[name] is not None:
            out[idx] = np.asarray(pose[name], np.float64)
    return out


def pose_array_to_dict(pose: np.ndarray) -> dict[str, np.ndarray]:
    """(J, 3) array -> {joint: (3,)} dict, omitting NaN joints."""
    out = {}
    for name, idx in JOINT_INDEX.items():
        if np.isfinite(pose[idx]).all():
            out[name] = np.asarray(pose[idx])
    return out


def sequence_to_array(poses: list[dict[str, np.ndarray]]) -> np.ndarray:
    """List of reference-style pose dicts -> (T, J, 3) with NaN gaps."""
    return np.stack([pose_dict_to_array(p) for p in poses])


def sequence_to_dicts(seq: np.ndarray) -> list[dict[str, np.ndarray]]:
    return [pose_array_to_dict(p) for p in np.asarray(seq)]
