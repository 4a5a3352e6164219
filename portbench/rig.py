"""A seeded calibrated stereo rig in plain numpy: its rectification maps, Q, and where raw pixels look.

Each camera has its own intrinsics, Brown-Conrady distortion (k1, k2, p1, p2) and a small rotation R_i
from the rectified frame, all drawn from the seed within the configuration's ``rig`` ranges; the rectified
pair shares focal ``f`` and principal point ((W-1)/2, (H-1)/2) with the baseline along x. The maps follow
cv2.initUndistortRectifyMap (a rectified pixel -> R_i^T -> distort -> the raw pixel), so the remap is not
the identity; ``raw_to_rectified`` inverts them (undistortion by fixed-point iteration, as
cv2.undistortPoints, then R_i), for rendering what each camera sees.
"""

from __future__ import annotations

import numpy as np


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta == 0.0:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def make_rig(seed: int, H: int, W: int, r: dict) -> dict:
    """The rig of ``seed``: per camera (K, dist, R), the rectified focal, principal point and baseline."""
    rng = np.random.default_rng([seed, 7])
    f = float(r["focal_px"])
    cams = []
    for _ in range(2):
        fx = f * (1 + rng.uniform(-r["focal_spread"], r["focal_spread"]))
        fy = fx * (1 + rng.uniform(-r["aspect_spread"], r["aspect_spread"]))
        cx = (W - 1) / 2 + rng.uniform(-r["center_px"], r["center_px"])
        cy = (H - 1) / 2 + rng.uniform(-r["center_px"], r["center_px"])
        dist = np.array([rng.uniform(*r["k1"]), rng.uniform(*r["k2"]), rng.uniform(-r["tangential"], r["tangential"]),
                         rng.uniform(-r["tangential"], r["tangential"])])
        R = _rodrigues(np.deg2rad(rng.uniform(-r["rotation_deg"], r["rotation_deg"], 3)))
        cams.append(dict(K=np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]), dist=dist, R=R))
    return dict(cams=cams, f=f, c=((W - 1) / 2, (H - 1) / 2), baseline=float(r["baseline_mm"]), H=H, W=W)


def _distort(x, y, dist):
    k1, k2, p1, p2 = dist
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def maps_and_q(rig: dict) -> tuple[tuple[np.ndarray, ...], np.ndarray]:
    """((map_x1, map_y1, map_x2, map_y2) float32 (H, W), Q float32 (4, 4)): a rectified pixel -> the raw
    pixel each camera samples; Q reprojects (u, v, d) to millimetres."""
    H, W, f, (cx, cy) = rig["H"], rig["W"], rig["f"], rig["c"]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    ray = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)])
    maps = []
    for cam in rig["cams"]:
        X = np.tensordot(cam["R"].T, ray, axes=1)
        xd, yd = _distort(X[0] / X[2], X[1] / X[2], cam["dist"])
        K = cam["K"]
        maps += [(K[0, 0] * xd + K[0, 2]).astype(np.float32), (K[1, 1] * yd + K[1, 2]).astype(np.float32)]
    Tx = -rig["baseline"]
    Q = np.array([[1, 0, 0, -cx], [0, 1, 0, -cy], [0, 0, 0, f], [0, 0, -1.0 / Tx, 0]], np.float32)
    return tuple(maps), Q


def raw_to_rectified(rig: dict, iterations: int = 8) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per camera, (u, v) float32 (H, W): the rectified coordinates its raw pixel (x, y) sees."""
    H, W, f, (cx, cy) = rig["H"], rig["W"], rig["f"], rig["c"]
    b, a = np.mgrid[0:H, 0:W].astype(np.float64)
    out = []
    for cam in rig["cams"]:
        K = cam["K"]
        xd, yd = (a - K[0, 2]) / K[0, 0], (b - K[1, 2]) / K[1, 1]
        x, y = xd.copy(), yd.copy()
        for _ in range(iterations):
            ex, ey = _distort(x, y, cam["dist"])
            x, y = x + (xd - ex), y + (yd - ey)
        X = np.tensordot(cam["R"], np.stack([x, y, np.ones_like(x)]), axes=1)
        out.append(((f * X[0] / X[2] + cx).astype(np.float32), (f * X[1] / X[2] + cy).astype(np.float32)))
    return out
