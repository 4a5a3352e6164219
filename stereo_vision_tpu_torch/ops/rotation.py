"""Rotation parameterisations: Rodrigues vector <-> matrix, Euler report.

Port of ``stereo_vision_tpu/ops/rotation.py`` (``cv2.Rodrigues`` parity,
Taylor branch at the origin, the theta ~ pi branch of the inverse). The
maths runs in the inputs' dtype (the tests feed float64) on their device.

The small matrix products of the geometry modules go through :func:`mm`,
an elementwise product and a sum: no float32 matrix multiply on the card
and so no TF32 setting can touch them (the JAX package needs its
``highest_precision`` decorator for the same reason on the TPU).
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.device import resolve_device

_EPS = 1e-8


def as_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays on its device unless ``device`` is
    given; anything else goes to ``device`` (None: the CUDA card, as every
    entry point of the port). ``dtype`` converts."""
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(torch.device(device))
    else:
        t = torch.as_tensor(x, device=resolve_device(device))
    return t if dtype is None else t.to(dtype)


def float_dtype(*xs: torch.Tensor) -> torch.dtype:
    """The promoted floating dtype of the tensors (float32 for integers)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt if dt.is_floating_point else torch.float32


def as_float_tensors(*xs, device=None) -> list[torch.Tensor]:
    """The arguments as tensors on the first one's device (see
    :func:`as_tensor`), in their promoted floating dtype."""
    first = as_tensor(xs[0], device)
    ts = [first] + [as_tensor(x, first.device) for x in xs[1:]]
    dt = float_dtype(*ts)
    return [t.to(dt) for t in ts]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two axes (broadcast batch axes), as products
    and a sum in the inputs' dtype."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` for a (..., n, m) matrix and an (..., m) vector."""
    return (a * v.unsqueeze(-2)).sum(-1)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of a 3-vector."""
    x, y, z = v[0], v[1], v[2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]), torch.stack([-y, x, zero])])


def rodrigues(rvec, device=None) -> torch.Tensor:
    """Rotation vector (3,) -> rotation matrix (3, 3), with the
    second-order Taylor form of sin(t)/t and (1 - cos(t))/t^2 where
    theta^2 < 1e-8."""
    rvec = as_tensor(rvec, device)
    rvec = rvec.to(float_dtype(rvec)).reshape(3)
    theta2 = (rvec * rvec).sum()
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = _hat(rvec)  # un-normalised: theta * hat(axis)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a * K + b * mm(K, K)


def rodrigues_inv(R, device=None) -> torch.Tensor:
    """Rotation matrix (3, 3) -> rotation vector (3,), ``cv2.Rodrigues(R)``
    for proper rotations, including theta ~ pi (the axis from the diagonal
    of (R + I) / 2, signs from the symmetric part's row of its largest
    component)."""
    R = as_tensor(R, device)
    R = R.to(float_dtype(R)).reshape(3, 3)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = 0.5 * torch.linalg.vector_norm(w)  # sin(theta)
    c = torch.clamp(0.5 * (torch.trace(R) - 1.0), -1.0, 1.0)  # cos(theta)
    theta = torch.atan2(s, c)
    generic = torch.where(s > 1e-6, theta / torch.clamp(2.0 * s, min=_EPS), 0.5) * w

    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    A = 0.5 * (R + eye)
    diag = torch.clamp(torch.diagonal(A) - c, min=0.0) / torch.clamp(1.0 - c, min=_EPS)
    axis_abs = torch.sqrt(diag + _EPS * _EPS)
    k = torch.argmax(axis_abs)
    off = 0.5 * (R + R.T)  # off[i, j] = (1 - c) r_i r_j for i != j
    signs = torch.sign(off[k, :] + 1e-30)
    axis_pi = axis_abs * signs * torch.sign(axis_abs[k] + _EPS)
    axis_pi = axis_pi / torch.clamp(torch.linalg.vector_norm(axis_pi), min=_EPS)
    near_pi = (s <= 1e-6) & (c < 0.0)
    return torch.where(near_pi, theta * axis_pi, generic)


def euler_angles_from_matrix(R, device=None) -> torch.Tensor:
    """XYZ (pitch-yaw-roll) Euler angles in degrees of a (3, 3) rotation."""
    R = as_tensor(R, device)
    R = R.to(float_dtype(R)).reshape(3, 3)
    sy = torch.sqrt(R[0, 0] * R[0, 0] + R[1, 0] * R[1, 0])
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-R[1, 2], R[1, 1]), torch.atan2(R[2, 1], R[2, 2]))
    y = torch.atan2(-R[2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[1, 0], R[0, 0]))
    return torch.rad2deg(torch.stack([x, y, z]))
