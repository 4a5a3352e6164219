"""Per-camera intrinsic calibration (cv2.calibrateCamera parity surface).

Port of ``stereo_vision_tpu/calib/intrinsics.py``: Zhang homography
initialization (numpy on the host, as in the reference), Levenberg-Marquardt
refinement over intrinsics + distortion + per-frame poses (all frames in one
residual, float64 on the device), and the reference's 2-round outlier-frame
rejection (error > 1.0 px, then > 1.5x mean; drop at most 20%, keep at least
10 frames).

Flag semantics mirror the reference's iPhone setup
(CALIB_RATIONAL_MODEL + FIX_K4 + FIX_K5 + FIX_K6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import vmap

from stereo_vision_tpu_torch.calib.lm import levenberg_marquardt
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.distortion import distort_normalized
from stereo_vision_tpu_torch.ops.rotation import mv, rodrigues


@dataclasses.dataclass(frozen=True)
class CalibrationFlags:
    """Subset of cv2 calibration flags the reference exercises."""

    rational_model: bool = True  # free k4..k6 unless fixed below
    fix_k4: bool = True  # reference iPhone default: rational
    fix_k5: bool = True  # model with k4..k6 pinned at 0
    fix_k6: bool = True
    fix_k3: bool = False
    fix_k2: bool = False
    fix_k1: bool = False
    zero_tangent_dist: bool = False
    fix_principal_point: bool = False
    fix_aspect_ratio: bool = False

    def dist_mask(self) -> np.ndarray:
        """(8,) mask over (k1 k2 p1 p2 k3 k4 k5 k6); 0 = frozen at 0."""
        m = np.ones(8)
        if self.fix_k1:
            m[0] = 0
        if self.fix_k2:
            m[1] = 0
        if self.zero_tangent_dist:
            m[2] = m[3] = 0
        if self.fix_k3:
            m[4] = 0
        if not self.rational_model or self.fix_k4:
            m[5] = 0
        if not self.rational_model or self.fix_k5:
            m[6] = 0
        if not self.rational_model or self.fix_k6:
            m[7] = 0
        return m


@dataclasses.dataclass
class CameraCalibration:
    K: np.ndarray  # (3, 3)
    dist: np.ndarray  # (8,) k1 k2 p1 p2 k3 k4 k5 k6
    rvecs: np.ndarray  # (F, 3) per kept frame
    tvecs: np.ndarray  # (F, 3)
    rms: float  # RMS reprojection error (px), cv2 convention
    per_frame_errors: np.ndarray  # (F,) mean px error per kept frame
    kept_frames: np.ndarray  # indices into the input frame list
    image_size: tuple[int, int]


def host_array(a) -> np.ndarray:
    """``a`` (numpy, a tensor on any device, nested lists) as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _homography_dlt(obj_xy: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Normalized DLT homography (obj plane -> image), host-side numpy."""

    def normalize(p):
        mean = p.mean(0)
        scale = np.sqrt(2.0) / np.maximum(np.linalg.norm(p - mean, axis=1).mean(), 1e-12)
        T = np.array([[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1) @ T.T
        return ph, T

    src, Ts = normalize(obj_xy)
    dst, Td = normalize(img)
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:3] = src
    A[0::2, 6:9] = -dst[:, 0:1] * src
    A[1::2, 3:6] = src
    A[1::2, 6:9] = -dst[:, 1:2] * src
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _pose_from_homography(h1: np.ndarray, h2: np.ndarray, h3: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rvec, tvec) of a plane from the columns of ``K^-1 H``: scale by the
    first, keep the board in front of the camera, project onto the nearest
    rotation."""
    s = 1.0 / max(np.linalg.norm(h1), 1e-12)
    r1, r2, t = s * h1, s * h2, s * h3
    if t[2] < 0:  # board must be in front of the camera
        r1, r2, t = -r1, -r2, -t
    r3 = np.cross(r1, r2)
    Rm = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(Rm)
    Rm = U @ Vt
    if np.linalg.det(Rm) < 0:
        Rm = U @ np.diag([1, 1, -1]) @ Vt
    return _rvec_from_R(Rm), t


def _zhang_init(
    obj: np.ndarray, corners: np.ndarray, image_size: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form K and per-frame pose initialization (Zhang 2000)."""
    F = corners.shape[0]
    Hs = [_homography_dlt(obj[:, :2], corners[f]) for f in range(F)]

    def v(H, i, j):
        return np.array(
            [
                H[0, i] * H[0, j],
                H[0, i] * H[1, j] + H[1, i] * H[0, j],
                H[1, i] * H[1, j],
                H[2, i] * H[0, j] + H[0, i] * H[2, j],
                H[2, i] * H[1, j] + H[1, i] * H[2, j],
                H[2, i] * H[2, j],
            ]
        )

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.stack(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    try:
        cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
        lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
        fx = np.sqrt(lam / b11)
        fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
        cx = -b13 * fx * fx / lam
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        ok = np.isfinite(K).all() and fx > 0 and fy > 0
    except (FloatingPointError, ZeroDivisionError):
        ok = False
    if not ok or not (0 < cx < image_size[0] and 0 < cy < image_size[1]):
        # Fallback: sensible pinhole prior (focal ~ image width).
        w, h = image_size
        K = np.array([[1.1 * w, 0, w / 2], [0, 1.1 * w, h / 2], [0, 0, 1.0]])

    Ki = np.linalg.inv(K)
    poses = [_pose_from_homography(Ki @ H[:, 0], Ki @ H[:, 1], Ki @ H[:, 2]) for H in Hs]
    return K, np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])


def _rvec_from_R(R: np.ndarray) -> np.ndarray:
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = 0.5 * np.linalg.norm(w)
    c = np.clip(0.5 * (np.trace(R) - 1.0), -1, 1)
    theta = np.arctan2(s, c)
    if s < 1e-9:
        return np.zeros(3)
    return w * (theta / (2 * s))


def board_in_camera(pose: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """(N, 3) camera coordinates of the board points ``obj`` under one
    pose (6,) = (rvec, tvec)."""
    return mv(rodrigues(pose[:3]), obj) + pose[3:]


def pixels(cam: torch.Tensor, fx, fy, cx, cy, dist) -> torch.Tensor:
    """(..., 2) pixels of camera points (..., 3) through a pinhole K without
    skew and the distortion ``dist``."""
    xyd = distort_normalized(cam[..., :2] / cam[..., 2:3], dist)
    return torch.stack([xyd[..., 0] * fx + cx, xyd[..., 1] * fy + cy], dim=-1)


def _residuals(params: torch.Tensor, obj: torch.Tensor, corners: torch.Tensor, fix_aspect: bool) -> torch.Tensor:
    """Flattened pixel residuals for all frames.

    params = [fx, fy, cx, cy, dist(8), (rvec, tvec) * F].
    """
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    if fix_aspect:
        fy = fx
    dist = params[4:12]
    proj = vmap(lambda pose: pixels(board_in_camera(pose, obj), fx, fy, cx, cy, dist))(params[12:].reshape(-1, 6))
    return (proj - corners).reshape(-1)


def _solve(
    obj: np.ndarray,
    corners: np.ndarray,
    K0: np.ndarray,
    dist0: np.ndarray,
    rvecs0: np.ndarray,
    tvecs0: np.ndarray,
    flags: CalibrationFlags,
    dev: torch.device,
    max_iters: int = 60,
):
    F = corners.shape[0]
    x0 = np.concatenate(
        [
            np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
            dist0,
            np.concatenate([rvecs0, tvecs0], axis=1).reshape(-1),
        ]
    )
    mask = np.ones_like(x0)
    mask[4:12] = flags.dist_mask()
    if flags.fix_principal_point:
        mask[2] = mask[3] = 0
    if flags.fix_aspect_ratio:
        mask[1] = 0

    objt = torch.as_tensor(obj, device=dev)
    corr = torch.as_tensor(corners, device=dev)
    fix_aspect = bool(flags.fix_aspect_ratio)

    res = levenberg_marquardt(
        lambda p: _residuals(p, objt, corr, fix_aspect),
        torch.as_tensor(x0, device=dev),
        max_iters=max_iters,
        mask=torch.as_tensor(mask, device=dev),
    )
    p = res.params.cpu().numpy()
    fx, fy, cx, cy = p[0], (p[0] if flags.fix_aspect_ratio else p[1]), p[2], p[3]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    dist = p[4:12]
    poses = p[12:].reshape(F, 6)

    r = _residuals(res.params, objt, corr, fix_aspect).cpu().numpy().reshape(F, -1, 2)
    per_point = np.linalg.norm(r, axis=-1)  # (F, N)
    per_frame = per_point.mean(axis=1)
    rms = float(np.sqrt((r**2).sum(-1).mean()))  # cv2 convention
    return K, dist, poses[:, :3], poses[:, 3:], rms, per_frame


def calibrate_camera(
    object_points: np.ndarray | Sequence[np.ndarray],
    image_points: np.ndarray | Sequence[np.ndarray],
    image_size: tuple[int, int],
    flags: CalibrationFlags = CalibrationFlags(),
    reject_outlier_frames: bool = True,
    error_threshold_px: float = 1.0,
    relative_threshold: float = 1.5,
    max_drop_fraction: float = 0.2,
    min_frames: int = 10,
    device=None,
) -> CameraCalibration:
    """Full intrinsic calibration with the reference's outlier policy.

    Args:
      object_points: (N, 3) board grid (same for all frames) or one per frame.
      image_points: (F, N, 2) detected corners.
      image_size: (width, height).
      reject_outlier_frames: run the reference's 2-round frame filtering:
        round 1 drops frames with mean error > ``error_threshold_px``;
        round 2 drops > ``relative_threshold`` x mean; each round drops at
        most ``max_drop_fraction`` and keeps at least ``min_frames``.
      device: where the solves run (None = the CUDA card; raises without one).
    """
    dev = resolve_device(device)
    corners = host_array(image_points)
    obj = host_array(object_points)
    if obj.ndim == 3:
        obj = obj[0]
    F = corners.shape[0]

    K0, rv0, tv0 = _zhang_init(obj, corners, image_size)
    dist0 = np.zeros(8)
    kept = np.arange(F)

    K, dist, rv, tv, rms, per_frame = _solve(obj, corners, K0, dist0, rv0, tv0, flags, dev)

    if reject_outlier_frames:
        for round_idx in range(2):
            if round_idx == 0:
                bad = per_frame > error_threshold_px
            else:
                bad = per_frame > relative_threshold * per_frame.mean()
            order = np.argsort(-per_frame)
            max_drop = int(len(kept) * max_drop_fraction)
            max_drop = min(max_drop, max(len(kept) - min_frames, 0))
            drop = [i for i in order if bad[i]][:max_drop]
            if not drop:
                continue
            keep_local = np.setdiff1d(np.arange(len(kept)), drop)
            kept = kept[keep_local]
            corners = corners[keep_local]
            K, dist, rv, tv, rms, per_frame = _solve(obj, corners, K, dist, rv[keep_local], tv[keep_local], flags, dev)

    return CameraCalibration(
        K=K,
        dist=dist,
        rvecs=rv,
        tvecs=tv,
        rms=rms,
        per_frame_errors=per_frame,
        kept_frames=kept,
        image_size=image_size,
    )
