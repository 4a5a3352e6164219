"""Stereo ball-trajectory analysis (drop / roll).

Port of ``stereo_vision_tpu/track/ball.py``: per-frame stereo detections
are undistorted and triangulated as one batch on the device, the drop
segment is located, and the kinematics recover gravity for the physical
validation. y (axis 1) grows downward.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.ball import BallDetection
from stereo_vision_tpu_torch.ops.distortion import undistort_points
from stereo_vision_tpu_torch.ops.triangulate import triangulate_points
from stereo_vision_tpu_torch.track.fusion import StereoRig
from stereo_vision_tpu_torch.track.kinematics import (
    GRAVITY_MM_S2,
    detect_start_of_motion,
    estimate_gravity,
    theoretical_drop_velocity,
)


class BallTrajectory(NamedTuple):
    positions_3d: np.ndarray     # (T, 3) mm, NaN where undetected
    timestamps: np.ndarray       # (T,) seconds
    drop_start: int              # index where motion begins
    gravity_mm_s2: float | None
    gravity_error_pct: float | None
    velocities: np.ndarray       # (T-1, 3) mm/s
    valid: np.ndarray            # (T,) detection mask


def triangulate_detections(rig: StereoRig, left_centers, right_centers, device=None) -> np.ndarray:
    """(T, 2) + (T, 2) pixel centres -> (T, 3) mm positions on ``device``
    (None: the CUDA card). NaN rows pass through."""
    left_centers = np.asarray(left_centers, np.float64)
    right_centers = np.asarray(right_centers, np.float64)
    K1, d1, K2, d2, R, T, P1, P2 = rig.as_arrays(device)
    lu = undistort_points(torch.nan_to_num(torch.as_tensor(left_centers, device=K1.device)), K1, d1, P=K1)
    ru = undistort_points(torch.nan_to_num(torch.as_tensor(right_centers, device=K1.device)), K2, d2, P=K2)
    p = triangulate_points(P1, P2, lu, ru).cpu().numpy()
    ok = np.isfinite(left_centers).all(-1) & np.isfinite(right_centers).all(-1)
    p[~ok] = np.nan
    return p


def analyze_ball_drop(
    rig: StereoRig,
    left_detections: Sequence[BallDetection | None],
    right_detections: Sequence[BallDetection | None],
    fps: float,
    drop_height_mm: float | None = None,
    device=None,
) -> BallTrajectory:
    """Triangulate -> motion start -> gravity: motion detection needs more
    than 10 valid frames and the gravity estimate at least 10 frames after
    the start."""
    T = len(left_detections)
    lc = np.full((T, 2), np.nan)
    rc = np.full((T, 2), np.nan)
    for i, (ld, rd) in enumerate(zip(left_detections, right_detections)):
        if ld is not None and rd is not None:
            lc[i] = (ld.cx, ld.cy)
            rc[i] = (rd.cx, rd.cy)
    pos = triangulate_detections(rig, lc, rc, device)
    valid = np.isfinite(pos).all(-1)
    ts = np.arange(T) / fps

    vp = pos[valid]
    vt = ts[valid]
    drop_start = 0
    g = err = None
    velocities = np.full((max(T - 1, 0), 3), np.nan)
    if valid.sum() > 10:
        drop_start = detect_start_of_motion(vp)
        if drop_start < len(vp) - 10:
            g, err = estimate_gravity(vp[drop_start:], vt[drop_start:] - vt[drop_start], device=device)
        dv = np.diff(vp, axis=0) / np.diff(vt)[:, None]
        velocities[np.flatnonzero(valid)[1:] - 1] = dv

    return BallTrajectory(
        positions_3d=pos,
        timestamps=ts,
        drop_start=int(drop_start),
        gravity_mm_s2=g,
        gravity_error_pct=err,
        velocities=velocities,
        valid=valid,
    )


def drop_report(traj: BallTrajectory, drop_height_mm: float | None = None) -> dict:
    """Summary dict of the reference's JSON / report outputs."""
    out = {
        "frames": int(len(traj.timestamps)),
        "valid_detections": int(traj.valid.sum()),
        "drop_start_index": traj.drop_start,
        "gravity_mm_s2": traj.gravity_mm_s2,
        "gravity_error_pct": traj.gravity_error_pct,
        "expected_gravity_mm_s2": GRAVITY_MM_S2,
    }
    if drop_height_mm is not None:
        out["theoretical_final_velocity_mm_s"] = theoretical_drop_velocity(drop_height_mm)
        v = traj.velocities
        ok = np.isfinite(v).all(-1)
        if ok.any():
            out["peak_measured_speed_mm_s"] = float(np.linalg.norm(v[ok], axis=1).max())
    return out
