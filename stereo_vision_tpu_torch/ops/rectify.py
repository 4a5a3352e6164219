"""Bouguet stereo rectification and rectification-map generation.

Port of ``stereo_vision_tpu/ops/rectify.py``: ``stereo_rectify``
(``cv2.stereoRectify`` with the cv2 >= 5 rules: mean cross-axis focal,
the inner/outer rectangles sampled over [0, w-1] x [0, h-1]) and
``init_undistort_rectify_map`` (``cv2.initUndistortRectifyMap``, CV_32FC1).
The rotation maths runs in the inputs' dtype (float64 for numpy float64
inputs) on their device, with the small products written out elementwise
(:func:`.rotation.mm`); the maps are one elementwise pass over the
destination grid, returned as float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_vision_tpu_torch.ops.distortion import distort_normalized, undistort_points
from stereo_vision_tpu_torch.ops.rotation import as_tensor, float_dtype, mm, mv, rodrigues, rodrigues_inv


class RectifyResult(NamedTuple):
    R1: torch.Tensor  # (3, 3) rectification rotation, camera 1
    R2: torch.Tensor  # (3, 3) rectification rotation, camera 2
    P1: torch.Tensor  # (3, 4) rectified projection, camera 1
    P2: torch.Tensor  # (3, 4) rectified projection, camera 2
    Q: torch.Tensor   # (4, 4) disparity-to-depth reprojection matrix


def _rectangles(K, dist, R, P, image_size, n: int = 9):
    """Inner and outer (x, y, w, h) rectangles of an n x n grid of source
    pixels over [0, w-1] x [0, h-1], undistorted into the rectified frame
    (OpenCV's icvGetRectangles): the outer bounds every point, the inner is
    bounded by the grid's border rows and columns."""
    w, h = image_size
    ar = torch.arange(n, dtype=K.dtype, device=K.device)
    gx, gy = torch.meshgrid(ar * ((w - 1) / (n - 1)), ar * ((h - 1) / (n - 1)), indexing="xy")
    u = undistort_points(torch.stack([gx, gy], dim=-1), K, dist, R=R, P=P[:, :3])  # (n, n, 2)
    ox0, oy0 = u[..., 0].min(), u[..., 1].min()
    ox1, oy1 = u[..., 0].max(), u[..., 1].max()
    ix0 = u[:, 0, 0].max()   # left column
    ix1 = u[:, -1, 0].min()  # right column
    iy0 = u[0, :, 1].max()   # top row
    iy1 = u[-1, :, 1].min()  # bottom row
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def stereo_rectify(K1, dist1, K2, dist2, image_size: tuple[int, int], R, T, alpha: float = -1.0,
                   new_image_size: tuple[int, int] | None = None, zero_disparity: bool = True,
                   horizontal_stereo: bool | None = None, device=None) -> RectifyResult:
    """Bouguet stereo rectification (``cv2.stereoRectify``).

    K1, K2: (3, 3) camera matrices; dist1, dist2: distortion coefficients;
    image_size: (width, height); R, T: camera 1 -> camera 2 rotation and
    translation; alpha: free scaling (-1 none, 0 crop to valid, 1 keep all
    source pixels); zero_disparity: CALIB_ZERO_DISPARITY; horizontal_stereo:
    the rig's layout (None: read from T). Tensors stay on their device,
    other inputs go to ``device`` (None: the CUDA card).
    """
    K1 = as_tensor(K1, device)
    dt, dev = float_dtype(K1), K1.device
    K1 = K1.to(dt)
    K2, dist1, dist2 = (as_tensor(a, dev, dt) for a in (K2, dist1, dist2))
    R = as_tensor(R, dev, dt).reshape(3, 3)
    T = as_tensor(T, dev, dt).reshape(3)
    nx, ny = image_size

    # Split the stereo rotation evenly between the two cameras.
    r_r = rodrigues(-0.5 * rodrigues_inv(R))
    t = mv(r_r, T)
    if horizontal_stereo is None:
        idx = int(bool(t[0].abs() <= t[1].abs()))  # 0: side by side, 1: stacked
    else:
        idx = 0 if horizontal_stereo else 1
    c = t[idx]
    nt = torch.linalg.vector_norm(t)
    zero = torch.zeros((), dtype=dt, device=dev)
    sign = torch.where(c > 0, 1.0, -1.0).to(dt)
    uu = torch.stack([sign if i == idx else zero for i in range(3)])

    # Global rotation aligning the baseline with the image x (or y) axis.
    ww = torch.linalg.cross(t, uu)
    nw = torch.linalg.vector_norm(ww)
    angle = torch.arccos(torch.clamp(c.abs() / torch.clamp(nt, min=1e-12), -1.0, 1.0))
    ww = torch.where(nw > 0, ww * (angle / torch.clamp(nw, min=1e-12)), ww)
    wR = rodrigues(ww)
    R1 = mm(wR, r_r.T)
    R2 = mm(wR, r_r)
    t_new = mv(R2, T)

    # New focal length: the mean of the two cross-axis focals (cv2 >= 5).
    fc_new = 0.5 * (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1])

    # New principal points: centre the undistorted, rectified image corners.
    corners = torch.tensor([[0.0, 0.0], [nx - 1.0, 0.0], [0.0, ny - 1.0], [nx - 1.0, ny - 1.0]], dtype=dt,
                           device=dev)
    centre = torch.tensor([(nx - 1) / 2, (ny - 1) / 2], dtype=dt, device=dev)
    cc = []
    for K, dist, Rk in ((K1, dist1, R1), (K2, dist2, R2)):
        xy = undistort_points(corners, K, dist)
        xyw = mv(Rk, torch.cat([xy, torch.ones_like(xy[:, :1])], dim=1))
        proj = fc_new * xyw[:, :2] / xyw[:, 2:3]
        cc.append(centre - proj.mean(dim=0))
    cc0, cc1 = cc
    if zero_disparity:
        cc0 = cc1 = 0.5 * (cc0 + cc1)
    else:  # share the coordinate across the baseline's normal
        o = idx ^ 1
        mid = 0.5 * (cc0[o] + cc1[o])
        cc0, cc1 = (torch.stack([v[0], mid] if o == 1 else [mid, v[1]]) for v in (cc0, cc1))

    def make_P(f, ccp, tk):
        P = torch.zeros((3, 4), dtype=dt, device=dev)
        P[0, 0] = P[1, 1] = f
        P[2, 2] = 1.0
        P[0, 2], P[1, 2] = ccp[0], ccp[1]
        if tk is not None:
            P[idx, 3] = tk
        return P

    P1 = make_P(fc_new, cc0, None)
    P2 = make_P(fc_new, cc1, t_new[idx] * fc_new)

    nwx, nwy = new_image_size or image_size
    cx1_0, cy1_0, cx2_0, cy2_0 = cc0[0], cc0[1], cc1[0], cc1[1]
    cx1, cy1 = nwx * cx1_0 / nx, nwy * cy1_0 / ny
    cx2, cy2 = nwx * cx2_0 / nx, nwy * cy2_0 / ny
    s = torch.ones((), dtype=dt, device=dev)

    if alpha >= 0:
        alpha = min(float(alpha), 1.0)
        inner1, outer1 = _rectangles(K1, dist1, R1, P1, image_size)
        inner2, outer2 = _rectangles(K2, dist2, R2, P2, image_size)

        def ratios(cx, cy, cx_0, cy_0, rect):
            x0, y0, rw, rh = rect
            return (cx / (cx_0 - x0), cy / (cy_0 - y0), (nwx - 1 - cx) / (x0 + rw - cx_0),
                    (nwy - 1 - cy) / (y0 + rh - cy_0))

        def scale0(*a):
            r = ratios(*a)
            return torch.maximum(torch.maximum(r[0], r[1]), torch.maximum(r[2], r[3]))

        def scale1(*a):
            r = ratios(*a)
            return torch.minimum(torch.minimum(r[0], r[1]), torch.minimum(r[2], r[3]))

        s0 = torch.maximum(scale0(cx1, cy1, cx1_0, cy1_0, inner1), scale0(cx2, cy2, cx2_0, cy2_0, inner2))
        s1 = torch.minimum(scale1(cx1, cy1, cx1_0, cy1_0, outer1), scale1(cx2, cy2, cx2_0, cy2_0, outer2))
        s = s0 * (1.0 - alpha) + s1 * alpha

    fc_new = fc_new * s
    cc0, cc1 = torch.stack([cx1, cy1]), torch.stack([cx2, cy2])
    P1 = make_P(fc_new, cc0, None)
    P2 = make_P(fc_new, cc1, t_new[idx] * fc_new)

    cdiff = cc0[idx] - cc1[idx]
    Q = torch.zeros((4, 4), dtype=dt, device=dev)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3] = -cc0[0], -cc0[1], fc_new
    Q[3, 2], Q[3, 3] = -1.0 / t_new[idx], cdiff / t_new[idx]
    return RectifyResult(R1, R2, P1, P2, Q)


def init_undistort_rectify_map(K, dist, R, new_K, size: tuple[int, int], device=None):
    """``cv2.initUndistortRectifyMap`` (CV_32FC1 pair): for each pixel of
    the (width, height) = ``size`` rectified image, back-rotate through
    ``R`` (None: plain undistortion), distort and map through ``K``.
    ``new_K`` is the (3, 3) or (3, 4) new camera or projection matrix.
    Returns (map_x, map_y), each (height, width) float32 source
    coordinates."""
    K = as_tensor(K, device)
    dt, dev = float_dtype(K), K.device
    K = K.to(dt)
    dist = as_tensor(dist, dev, dt)
    new_K = as_tensor(new_K, dev, dt)[:3, :3]
    R = torch.eye(3, dtype=dt, device=dev) if R is None else as_tensor(R, dev, dt).reshape(3, 3)
    iR = torch.linalg.inv(mm(new_K, R))
    w, h = size
    gv, gu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    gu, gv = gu.to(dt), gv.to(dt)
    x, y, z = (iR[i, 0] * gu + iR[i, 1] * gv + iR[i, 2] for i in range(3))
    xyd = distort_normalized(torch.stack([x / z, y / z], dim=-1), dist)
    map_x = K[0, 0] * xyd[..., 0] + K[0, 1] * xyd[..., 1] + K[0, 2]
    map_y = K[1, 1] * xyd[..., 1] + K[1, 2]
    return map_x.to(torch.float32), map_y.to(torch.float32)
