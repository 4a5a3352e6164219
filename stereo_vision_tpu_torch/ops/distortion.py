"""Pinhole + rational lens distortion: forward projection and its inverse.

Port of ``stereo_vision_tpu/ops/distortion.py`` (``cv2.projectPoints`` and
``cv2.undistortPoints`` parity). Distortion coefficients are OpenCV's
rational model ``(k1, k2, p1, p2, k3, k4, k5, k6)``; shorter vectors are
padded with zeros. Everything runs in the promoted dtype of the inputs on
their device, elementwise (no matrix multiply, see :mod:`.rotation`).
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.ops.rotation import as_float_tensors, as_tensor, mv, rodrigues


def _dist8(dist: torch.Tensor) -> torch.Tensor:
    """A distortion vector padded (or cut) to 8 coefficients."""
    dist = dist.reshape(-1)
    n = dist.shape[0]
    if n >= 8:
        return dist[:8]
    return torch.cat([dist, torch.zeros(8 - n, dtype=dist.dtype, device=dist.device)])


def distort_normalized(xy, dist, device=None) -> torch.Tensor:
    """Forward distortion of (..., 2) normalised coordinates (X/Z, Y/Z) ->
    (..., 2) distorted normalised coordinates (before K)."""
    xy, dist = as_float_tensors(xy, dist, device=device)
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    den = 1.0 + k4 * r2 + k5 * r4 + k6 * r6
    radial = num / den
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project_points(obj_points, rvec, tvec, K, dist, device=None) -> torch.Tensor:
    """(..., 3) world points -> (..., 2) pixels through the rotation vector
    ``rvec``, translation ``tvec``, camera matrix ``K`` (skew supported) and
    distortion ``dist``: ``cv2.projectPoints``."""
    obj_points, rvec, tvec, K, dist = as_float_tensors(obj_points, rvec, tvec, K, dist, device=device)
    R = rodrigues(rvec)
    cam = mv(R, obj_points) + tvec.reshape(3)
    xy = cam[..., :2] / cam[..., 2:3]
    xyd = distort_normalized(xy, dist)
    u = xyd[..., 0] * K[0, 0] + K[0, 2] + K[0, 1] * xyd[..., 1]
    v = xyd[..., 1] * K[1, 1] + K[1, 2]
    return torch.stack([u, v], dim=-1)


def undistort_normalized(xy_dist, dist, iters: int = 5, device=None) -> torch.Tensor:
    """Inverse distortion of (..., 2) normalised coordinates: OpenCV's
    fixed-point compensation, ``iters`` rounds (cv2 runs 5)."""
    xy_dist, dist = as_float_tensors(xy_dist, dist, device=device)
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist8(dist)
    x0, y0 = xy_dist[..., 0], xy_dist[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1.0 + k4 * r2 + k5 * r4 + k6 * r6) / (1.0 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


def undistort_points(pts, K, dist, R=None, P=None, iters: int = 5, device=None) -> torch.Tensor:
    """``cv2.undistortPoints``: (..., 2) pixels -> undistorted normalised
    coordinates, or, with the rectification rotation ``R`` and the new
    projection ``P`` (3x3 or 3x4), pixels of the rectified frame."""
    pts, K, dist = as_float_tensors(pts, K, dist, device=device)
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    x = (pts[..., 0] - K[0, 2] - K[0, 1] * y) / K[0, 0]
    xy = undistort_normalized(torch.stack([x, y], dim=-1), dist, iters=iters)
    if R is None and P is None:
        return xy
    xyw = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    if R is not None:
        R = as_tensor(R, xy.device, xy.dtype).reshape(3, 3)
        xyw = mv(R, xyw)
    xy = xyw[..., :2] / xyw[..., 2:3]
    if P is None:
        return xy
    P = as_tensor(P, xy.device, xy.dtype)
    u = xy[..., 0] * P[0, 0] + P[0, 2] + P[0, 1] * xy[..., 1]
    v = xy[..., 1] * P[1, 1] + P[1, 2]
    return torch.stack([u, v], dim=-1)
