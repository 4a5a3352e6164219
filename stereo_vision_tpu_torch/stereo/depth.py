"""Disparity -> depth / 3D reprojection through the rectification Q matrix.

Port of ``stereo_vision_tpu/stereo/depth.py``. The product with Q stays
elementwise (broadcast sums in a fixed order, no matmul), as in the JAX
reference, so both compute the same float32 expression.
"""

from __future__ import annotations

import torch


def reproject_disparity_to_3d(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(..., H, W) disparity -> (..., H, W, 3) points via the 4x4 Q matrix.

    Non-positive disparities give non-finite Z; callers mask.
    """
    H, W = disparity.shape[-2:]
    Q = torch.as_tensor(Q, device=disparity.device)
    gu = torch.arange(W, dtype=disparity.dtype, device=disparity.device).expand(H, W)
    gv = torch.arange(H, dtype=disparity.dtype, device=disparity.device)[:, None].expand(H, W)
    vec = (gu, gv, disparity, torch.ones_like(disparity))
    out = []
    for r in range(4):
        acc = Q[r, 0] * vec[0]
        for c in range(1, 4):
            acc = acc + Q[r, c] * vec[c]
        out.append(acc)
    w = out[3]
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


def depth_from_disparity(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Z-only fast path: Z = Q[2,3] / (Q[3,2]*d + Q[3,3])."""
    Q = torch.as_tensor(Q, device=disparity.device)
    return Q[2, 3] / (Q[3, 2] * disparity + Q[3, 3])
