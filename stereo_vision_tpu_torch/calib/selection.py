"""Diversity-based calibration-frame selection.

Port of ``stereo_vision_tpu/calib/selection.py``: each detected board gets
a 6-dim feature vector (normalized center (2), corner-spread sigma (1),
principal-axis angle as cos/sin (2), aspect ratio (1)), and frames are kept
greedily if their min Euclidean distance to the already selected features
reaches a threshold.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor


def frame_diversity_features(corners, image_size: tuple[int, int], device=None) -> torch.Tensor:
    """(F, 6) feature vectors from (F, N, 2) detected corner sets, in their
    floating dtype (float32 for integers) on ``device`` (None = the CUDA
    card; a tensor stays on its device)."""
    w, h = image_size
    c = as_tensor(corners, device)
    if not c.dtype.is_floating_point:
        c = c.to(torch.float32)
    center = c.mean(dim=1)  # (F, 2)
    center_n = center / torch.tensor([w, h], dtype=c.dtype, device=c.device)
    rel = c - center[:, None, :]
    # The population std, as jnp.std.
    spread = torch.sqrt((rel**2).sum(-1)).std(dim=1, correction=0) / math.sqrt(w * w + h * h)

    # Principal axis via the 2x2 covariance's dominant eigenvector: the angle
    # of [[a, b], [b, d]]'s is 0.5 * atan2(2b, a - d). Products and sums, no matmul.
    cov = (rel[..., :, None] * rel[..., None, :]).sum(1) / c.shape[1]
    ang = 0.5 * torch.atan2(2 * cov[:, 0, 1], cov[:, 0, 0] - cov[:, 1, 1])
    ext = c.amax(dim=1) - c.amin(dim=1)
    aspect = ext[:, 0] / torch.clamp(ext[:, 1], min=1e-6)
    return torch.cat(
        [center_n, spread[:, None], torch.cos(ang)[:, None], torch.sin(ang)[:, None], aspect[:, None]], dim=1
    )


def select_diverse_frames(
    corners,
    image_size: tuple[int, int],
    max_frames: int = 25,
    min_distance: float = 0.15,
    device=None,
) -> np.ndarray:
    """Greedy min-distance selection; returns kept frame indices."""
    feats = frame_diversity_features(corners, image_size, device).cpu().numpy()
    kept: list[int] = []
    for i in range(len(feats)):
        if len(kept) >= max_frames:
            break
        if not kept:
            kept.append(i)
            continue
        d = np.linalg.norm(feats[kept] - feats[i], axis=1).min()
        if d >= min_distance:
            kept.append(i)
    return np.asarray(kept, np.int64)
