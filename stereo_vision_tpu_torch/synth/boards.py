"""Synthetic checkerboard detections for the calibration checks.

A board of ``cols x rows`` inner corners seen from random poses by one
camera or by both cameras of a rig, projected with the port's
``ops.project_points`` in float64 on the CPU, with Gaussian pixel noise.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops import project_points, rodrigues, rodrigues_inv


def board_views(n_frames: int, seed: int, K1, dist1, size: tuple[int, int], K2=None, dist2=None, R=None, T=None,
                cols: int = 9, rows: int = 6, square: float = 100.0, depth: tuple[float, float] = (1500.0, 3500.0),
                noise: float = 0.1, margin: float = 20.0):
    """(obj (N, 3), corners1 (F, N, 2)[, corners2 (F, N, 2)]) numpy float64:
    the board's points (row-major, x fastest, z = 0, ``square`` apart) and
    their pixels in camera 1 (``K1``, ``dist1``) and, with ``K2``, in camera
    2 at ``X2 = R X1 + T``. Poses are drawn from ``seed`` (rotation vectors
    within +-0.5 rad, the board's origin ``depth`` away) until ``n_frames``
    of them show the whole board ``margin`` px inside every camera's
    ``size`` = (width, height)."""
    rng = np.random.default_rng(seed)
    obj = np.zeros((rows * cols, 3))
    obj[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2) * square
    t64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    cams = [(t64(K1), t64(dist1), torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))]
    if K2 is not None:
        cams.append((t64(K2), t64(dist2), t64(R), t64(T)))
    views: list[list[np.ndarray]] = [[] for _ in cams]
    while len(views[0]) < n_frames:
        rvec = t64(rng.uniform(-0.5, 0.5, 3))
        z = rng.uniform(*depth)
        tvec = t64([rng.uniform(-0.45, 0.15) * z, rng.uniform(-0.35, 0.1) * z, z])
        pts = []
        for K, dist, Rc, Tc in cams:
            rv = rodrigues_inv(Rc @ rodrigues(rvec))
            p = project_points(t64(obj), rv, Rc @ tvec + Tc, K, dist).numpy()
            pts.append(p)
        if all((p > margin).all() and (p[:, 0] < size[0] - margin).all() and (p[:, 1] < size[1] - margin).all()
               for p in pts):
            for v, p in zip(views, pts):
                v.append(p + rng.normal(0, noise, p.shape))
    return (obj, *(np.stack(v) for v in views))
