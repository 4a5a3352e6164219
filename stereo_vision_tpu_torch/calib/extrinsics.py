"""Stereo extrinsic calibration (cv2.stereoCalibrate CALIB_FIX_INTRINSIC).

Port of ``stereo_vision_tpu/calib/extrinsics.py``: joint Levenberg-Marquardt
over the stereo transform (R, T) and per-frame board poses, with both
cameras' intrinsics held fixed (one residual over all frames and both views,
float64 on the device). E and F are computed with numpy on the host, as in
the reference, with the baseline ||T||.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from stereo_vision_tpu_torch.calib.intrinsics import (_homography_dlt, _pose_from_homography, _rvec_from_R,
                                                      board_in_camera, host_array, pixels)
from stereo_vision_tpu_torch.calib.lm import levenberg_marquardt
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.distortion import undistort_points
from stereo_vision_tpu_torch.ops.rotation import mv, rodrigues


@dataclasses.dataclass
class StereoCalibration:
    R: np.ndarray  # (3, 3) camera1 -> camera2 rotation
    T: np.ndarray  # (3,) translation
    E: np.ndarray  # (3, 3) essential matrix
    F: np.ndarray  # (3, 3) fundamental matrix
    rms: float  # RMS reprojection error over both views (px)
    baseline: float  # ||T||
    per_frame_errors: np.ndarray


def _hat_np(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def _residuals(params, obj, c1, c2, K1, d1, K2, d2) -> torch.Tensor:
    """params = [rvec_s(3), tvec_s(3), (rvec, tvec) * F]: poses are the board
    in camera 1's frame; camera 2 adds the stereo transform."""
    Rs, ts = rodrigues(params[:3]), params[3:6]

    def per_frame(pose):
        cam1 = board_in_camera(pose, obj)
        cam2 = mv(Rs, cam1) + ts
        return (pixels(cam1, K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2], d1),
                pixels(cam2, K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], d2))

    p1, p2 = vmap(per_frame)(params[6:].reshape(-1, 6))
    return torch.cat([(p1 - c1).reshape(-1), (p2 - c2).reshape(-1)])


def calibrate_stereo(
    object_points: np.ndarray,
    image_points1: np.ndarray,
    image_points2: np.ndarray,
    K1: np.ndarray,
    dist1: np.ndarray,
    K2: np.ndarray,
    dist2: np.ndarray,
    image_size: tuple[int, int],
    max_iters: int = 80,
    device=None,
) -> StereoCalibration:
    """FIX_INTRINSIC stereo calibration from matched board detections.

    Args:
      object_points: (N, 3) board grid.
      image_points1/2: (F, N, 2) matched corners per camera.
      K1, dist1, K2, dist2: fixed intrinsics (from calibrate_camera).
      image_size: (width, height), unused: the reference passes it only to
        a Zhang initialization whose result it discards.
      device: where the solve runs (None = the CUDA card; raises without one).
    """
    dev = resolve_device(device)
    obj = host_array(object_points)
    if obj.ndim == 3:
        obj = obj[0]
    c1 = host_array(image_points1)
    c2 = host_array(image_points2)
    K1, K2 = host_array(K1), host_array(K2)
    d1, d2 = host_array(dist1).ravel(), host_array(dist2).ravel()
    F_n = c1.shape[0]

    # Init: per-frame poses in each camera from undistorted homographies with
    # the given intrinsics, the stereo transform as the average relative pose.
    rv1, tv1 = _poses_with_known_K(obj, c1, K1, d1)
    rv2, tv2 = _poses_with_known_K(obj, c2, K2, d2)

    Rs_acc = np.zeros((3, 3))
    T_acc = np.zeros(3)
    for f in range(F_n):
        R1m = _R_from_rvec(rv1[f])
        R2m = _R_from_rvec(rv2[f])
        Rrel = R2m @ R1m.T
        Trel = tv2[f] - Rrel @ tv1[f]
        Rs_acc += Rrel
        T_acc += Trel
    U, _, Vt = np.linalg.svd(Rs_acc / F_n)
    Rs0 = U @ Vt
    if np.linalg.det(Rs0) < 0:
        Rs0 = U @ np.diag([1, 1, -1]) @ Vt
    Ts0 = T_acc / F_n

    x0 = np.concatenate([_rvec_from_R(Rs0), Ts0, np.concatenate([rv1, tv1], axis=1).reshape(-1)])

    args = [torch.as_tensor(a, device=dev) for a in (obj, c1, c2, K1, d1, K2, d2)]
    res = levenberg_marquardt(lambda p: _residuals(p, *args), torch.as_tensor(x0, device=dev), max_iters=max_iters)
    p = res.params.cpu().numpy()
    R = _R_from_rvec(p[:3])
    T = p[3:6]

    r = _residuals(res.params, *args).cpu().numpy()
    n_half = r.size // 2
    pts = r.reshape(-1, 2)
    rms = float(np.sqrt((pts**2).sum(-1).mean()))
    per_frame = (
        np.linalg.norm(r[:n_half].reshape(F_n, -1, 2), axis=-1).mean(1)
        + np.linalg.norm(r[n_half:].reshape(F_n, -1, 2), axis=-1).mean(1)
    ) / 2.0

    E = _hat_np(T) @ R
    Fm = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
    if abs(Fm[2, 2]) > 1e-12:
        Fm = Fm / Fm[2, 2]

    return StereoCalibration(R=R, T=T, E=E, F=Fm, rms=rms, baseline=float(np.linalg.norm(T)),
                             per_frame_errors=per_frame)


def _R_from_rvec(rv: np.ndarray) -> np.ndarray:
    return rodrigues(torch.as_tensor(rv, dtype=torch.float64), device="cpu").numpy()


def _poses_with_known_K(obj, corners, K, dist):
    """Planar-PnP pose init on the host: undistort corners (20 rounds),
    homography against the board plane, decomposed with the known K."""
    Kt, dt = torch.as_tensor(K), torch.as_tensor(dist)
    rvs, tvs = [], []
    for f in range(corners.shape[0]):
        norm = undistort_points(torch.as_tensor(corners[f]), Kt, dt, iters=20).numpy()
        H = _homography_dlt(obj[:, :2], norm)  # obj plane -> normalized cam
        rv, t = _pose_from_homography(H[:, 0], H[:, 1], H[:, 2])
        rvs.append(rv)
        tvs.append(t)
    return np.stack(rvs), np.stack(tvs)
