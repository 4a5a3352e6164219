"""3D joint angles.

Port of ``stereo_vision_tpu/track/angles.py``: the 8 named angles, each
the arccos of normalised (a - b) . (c - b), for every frame at once on the
poses' device.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.track.joints import ANGLE_NAMES, ANGLE_TRIPLE_INDICES


def angle_3d(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Angle at vertex b between rays b->a and b->c, degrees (broadcasts),
    with the dot product clamped to [-1, 1]."""
    ba = a - b
    bc = c - b
    ban = ba / torch.linalg.vector_norm(ba, dim=-1, keepdim=True).clamp(min=1e-12)
    bcn = bc / torch.linalg.vector_norm(bc, dim=-1, keepdim=True).clamp(min=1e-12)
    d = torch.clamp((ban * bcn).sum(-1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(d))


def pose_angles(pose, device=None) -> torch.Tensor:
    """(..., J, 3) poses -> (..., 8) joint angles in ANGLE_NAMES order; an
    angle with a missing (NaN) joint is NaN."""
    pose = as_tensor(pose, device)
    idx = torch.as_tensor(ANGLE_TRIPLE_INDICES, dtype=torch.long, device=pose.device)
    return angle_3d(pose[..., idx[:, 0], :], pose[..., idx[:, 1], :], pose[..., idx[:, 2], :])


def pose_angles_dict(pose, device=None) -> dict[str, float]:
    """One pose's {name: degrees}, omitting angles with missing joints."""
    vals = pose_angles(pose, device).cpu().numpy()
    return {n: float(v) for n, v in zip(ANGLE_NAMES, vals) if np.isfinite(v)}
