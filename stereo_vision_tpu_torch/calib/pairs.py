"""Per-pair quality filtering for stereo calibration.

Port of ``stereo_vision_tpu/calib/pairs.py``: each matched frame pair is
scored by its per-frame reprojection error in one joint stereo solve, and
pairs above the RMS threshold are dropped before the final calibration.
"""

from __future__ import annotations

import numpy as np

from stereo_vision_tpu_torch.calib.extrinsics import calibrate_stereo


def filter_pairs_by_rms(
    object_points: np.ndarray,
    corners_left: np.ndarray,
    corners_right: np.ndarray,
    K1: np.ndarray,
    d1: np.ndarray,
    K2: np.ndarray,
    d2: np.ndarray,
    image_size: tuple[int, int],
    max_rms: float = 2.0,
    min_pairs: int = 5,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score each pair by the full-set per-frame reprojection error and drop
    outlier pairs (keep RMS <= ``max_rms``; if fewer than ``min_pairs``
    remain, keep the best ``min_pairs``).

    Returns:
      (kept indices, filtered corners_left, filtered corners_right).
    """
    F = corners_left.shape[0]
    cal = calibrate_stereo(object_points, corners_left, corners_right, K1, d1, K2, d2, image_size, device=device)
    per_frame = np.asarray(cal.per_frame_errors)
    keep = per_frame <= max_rms
    if keep.sum() < min_pairs:
        # keep the best min_pairs instead of failing outright
        order = np.argsort(per_frame)
        keep = np.zeros(F, bool)
        keep[order[:min_pairs]] = True
    idx = np.flatnonzero(keep)
    return idx, corners_left[idx], corners_right[idx]
