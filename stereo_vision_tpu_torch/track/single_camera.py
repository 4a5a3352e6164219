"""Single-camera pose analytics.

Port of ``stereo_vision_tpu/track/single_camera.py``: a (T, 33, C)
landmark sequence -> joint angles and per-joint statistics, no
calibration; the angles of all frames as one batch on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.track.dual_camera import _angles_and_conf
from stereo_vision_tpu_torch.track.joints import ANGLE_NAMES


class SingleCameraResult(NamedTuple):
    angles: np.ndarray           # (T, 8) degrees, NaN where not confident
    mean_confidence: np.ndarray  # (T, 8)
    stats: dict[str, dict[str, float]]


def analyze_single_camera(landmarks, conf_threshold: float = 0.5, device=None) -> SingleCameraResult:
    """(T, 33, 4) landmarks -> joint angles + per-joint mean / std / min /
    max over the confident frames, on ``device`` (None: the CUDA card)."""
    ang, conf = _angles_and_conf(as_tensor(landmarks, device, torch.float64), conf_threshold)
    ang = ang.cpu().numpy()
    conf = conf.cpu().numpy()
    stats: dict[str, dict[str, float]] = {}
    for j, name in enumerate(ANGLE_NAMES):
        col = ang[:, j]
        ok = np.isfinite(col)
        if ok.any():
            stats[name] = {
                "mean": float(np.mean(col[ok])),
                "std": float(np.std(col[ok])),
                "min": float(np.min(col[ok])),
                "max": float(np.max(col[ok])),
                "visible_fraction": float(ok.mean()),
            }
        else:
            stats[name] = {"visible_fraction": 0.0}
    return SingleCameraResult(ang, conf, stats)
