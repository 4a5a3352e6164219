"""Uncalibrated dual-camera pose analysis.

Port of ``stereo_vision_tpu/track/dual_camera.py``: per-camera joint
angles gated by the triple's visibilities, per-joint selection from the
higher-confidence camera, and occlusion statistics per joint. The angles
of all frames run as one batch on the device; the selection and the
counts on the host, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.track.angles import angle_3d
from stereo_vision_tpu_torch.track.joints import ANGLE_NAMES, ANGLE_TRIPLE_INDICES, MEDIAPIPE_INDICES


class DualCameraResult(NamedTuple):
    left_angles: np.ndarray      # (T, 8), NaN where joints not confident
    right_angles: np.ndarray     # (T, 8)
    combined_angles: np.ndarray  # (T, 8) per-joint best-camera selection
    chose_left: np.ndarray       # (T, 8) bool: which camera won
    occlusion_stats: dict[str, dict[str, int]]


def _angles_and_conf(landmarks: torch.Tensor, conf_threshold: float):
    """(T, 33, 4) -> ((T, 8) angles, NaN unless all three joints of the
    triple reach ``conf_threshold``; (T, 8) mean visibility of the triple)."""
    dev = landmarks.device
    key = landmarks[:, torch.as_tensor(MEDIAPIPE_INDICES, dtype=torch.long, device=dev)]  # (T, 13, 4)
    idx = torch.as_tensor(ANGLE_TRIPLE_INDICES, dtype=torch.long, device=dev)
    a, b, c = (key[:, idx[:, k]] for k in range(3))
    ang = angle_3d(a[..., :3], b[..., :3], c[..., :3])
    conf = (a[..., 3] + b[..., 3] + c[..., 3]) / 3.0
    ok = (a[..., 3] >= conf_threshold) & (b[..., 3] >= conf_threshold) & (c[..., 3] >= conf_threshold)
    return torch.where(ok, ang, torch.nan), conf


def analyze_dual_camera(left_landmarks, right_landmarks, conf_threshold: float = 0.5,
                        device=None) -> DualCameraResult:
    """Per-joint best-camera angle selection + occlusion statistics of two
    (T, 33, 4) landmark sequences (x, y, z, visibility), on ``device``
    (None: the CUDA card).

    Where both cameras give the angle, the one whose triple's mean
    visibility is higher wins (ties: left); else whichever has it.
    """
    la, lc = _angles_and_conf(as_tensor(left_landmarks, device, torch.float64), conf_threshold)
    ra, rc = _angles_and_conf(as_tensor(right_landmarks, la.device, torch.float64), conf_threshold)
    la, lc, ra, rc = (t.cpu().numpy() for t in (la, lc, ra, rc))

    l_ok = np.isfinite(la)
    r_ok = np.isfinite(ra)
    chose_left = (l_ok & ~r_ok) | (l_ok & r_ok & (lc >= rc))
    combined = np.where(chose_left, la, ra)
    combined = np.where(l_ok | r_ok, combined, np.nan)

    stats: dict[str, dict[str, int]] = {}
    for j, name in enumerate(ANGLE_NAMES):
        stats[name] = {
            "both_visible": int((l_ok[:, j] & r_ok[:, j]).sum()),
            "left_visible": int((l_ok[:, j] & ~r_ok[:, j]).sum()),
            "right_visible": int((~l_ok[:, j] & r_ok[:, j]).sum()),
            "neither_visible": int((~l_ok[:, j] & ~r_ok[:, j]).sum()),
        }
    return DualCameraResult(la, ra, combined, chose_left, stats)


def occlusion_matrix(stats: dict[str, dict[str, int]]) -> np.ndarray:
    """(8, 4) visibility-category counts in ANGLE_NAMES order."""
    cats = ("both_visible", "left_visible", "right_visible", "neither_visible")
    return np.array([[stats[n][c] for c in cats] for n in ANGLE_NAMES])
