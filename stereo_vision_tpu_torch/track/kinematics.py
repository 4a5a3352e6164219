"""Finite-difference kinematics and motion-event detection.

Port of ``stereo_vision_tpu/track/kinematics.py``: velocity and
acceleration chains over the time axis, the gravity estimate against
9800 mm/s^2 (a float64 least-squares fit on the device), start-of-motion
detection and the free-fall velocity sqrt(2 g h).
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor

GRAVITY_MM_S2 = 9800.0  # the reference's expectation


def finite_difference(x: torch.Tensor, dt) -> torch.Tensor:
    """(T, ...) positions -> (T-1, ...) derivative dx / dt.

    ``dt`` is a scalar or a (T,) timestamp tensor (non-uniform sampling).
    """
    dx = x[1:] - x[:-1]
    if not isinstance(dt, torch.Tensor) or dt.ndim == 0:
        return dx / dt
    dts = dt[1:] - dt[:-1]
    return dx / dts.reshape((-1,) + (1,) * (x.ndim - 1))


def joint_velocities(seq, time_delta: float = 1.0 / 30.0, device=None) -> torch.Tensor:
    """(T, J, 3) -> (T-1, J, 3) velocities."""
    return finite_difference(as_tensor(seq, device), time_delta)


def joint_accelerations(velocities, time_delta: float = 1.0 / 30.0, device=None) -> torch.Tensor:
    """(T-1, J, 3) -> (T-2, J, 3) accelerations."""
    return finite_difference(as_tensor(velocities, device), time_delta)


def estimate_gravity(
    positions,
    timestamps,
    up_axis: int = 1,
    up_is_negative: bool = True,
    method: str = "fit",
    device=None,
) -> tuple[float, float]:
    """Vertical acceleration estimate and its % error against 9800 mm/s^2,
    in float64 on ``device`` (None: the card; tensors stay on theirs).

    method="fit" (default): least-squares quadratic fit of the vertical
    coordinate over time, gravity = twice its t^2 coefficient.
    method="fd": velocities then accelerations by finite differences,
    gravity = their mean along the vertical axis (the reference's
    estimator; its error grows as 1/T with the detection noise).
    ``up_is_negative`` (default): the axis grows downward (image and camera
    frames), so a free fall has a_y = +g; pass False for a y-up frame. The
    error is on the magnitude.

    Returns:
      (gravity_mm_s2, error_percent).
    """
    p = as_tensor(positions, device, torch.float64)
    t = as_tensor(timestamps, p.device, torch.float64)
    if method == "fit":
        y = p[:, up_axis]
        ts = t - t[0]
        A = torch.stack([ts * ts, ts, torch.ones_like(ts)], dim=1)
        coef = torch.linalg.lstsq(A, y[:, None]).solution[:, 0]
        a_y = 2.0 * coef[0]
        g = float(a_y if up_is_negative else -a_y)
    else:
        v = finite_difference(p, t)
        a = finite_difference(v, t[1:])
        g_series = a[:, up_axis] if up_is_negative else -a[:, up_axis]
        g = float(g_series.mean())
    err = abs(abs(g) - GRAVITY_MM_S2) / GRAVITY_MM_S2 * 100.0
    return g, err


def detect_start_of_motion(positions: np.ndarray, num_frames: int = 5, threshold: float = 5.0, axis: int = 1) -> int:
    """First frame before sustained vertical motion: ``num_frames``
    consecutive |dy| > threshold (the frame before the run), else the first
    single |dy| > 2 threshold, else 0. Host numpy."""
    if isinstance(positions, torch.Tensor):
        positions = positions.detach().cpu().numpy()
    positions = np.asarray(positions)
    if len(positions) < num_frames + 1:
        return 0
    y = positions[:, axis]
    dy = np.abs(np.diff(y))
    if len(dy) >= num_frames:
        from numpy.lib.stride_tricks import sliding_window_view

        runs = sliding_window_view(dy, num_frames).min(axis=1) > threshold
        hits = np.flatnonzero(runs)
        if hits.size:
            return max(0, int(hits[0]) - 1)
    big = np.flatnonzero(dy > threshold * 2)
    if big.size:
        return int(big[0])
    return 0


def theoretical_drop_velocity(height_mm: float, g: float = GRAVITY_MM_S2) -> float:
    """sqrt(2 g h), the free-fall speed after ``height_mm``."""
    return float(np.sqrt(2.0 * g * height_mm))
