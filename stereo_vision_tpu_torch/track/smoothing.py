"""Motion smoothing: Savitzky-Golay, moving average, One-Euro, and the
MotionSmoother orchestration.

Port of ``stereo_vision_tpu/track/smoothing.py``:

- the three camera presets;
- Savitzky-Golay with scipy's default 'interp' edges: the interior taps as
  one windowed sum over every (joint, axis) trajectory at once, the first
  and last half-window samples from the polynomial-fit edge operators
  (products and sums, no float32 matrix multiply on the card);
- the moving average, its edges keeping their original values;
- the One-Euro filter, whose ``lax.scan`` is a loop over time here with
  its state on the trajectories' device;
- the sequence order: reference limb lengths measured before smoothing,
  then the filter, the anatomical and the velocity constraints, with the
  same stats counters.

A trajectory with NaN gaps is compressed to its valid samples, filtered
and scattered back on the host, one series at a time; fully valid
sequences (the common case) filter as one batch on the device.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.track.constraints import (
    apply_anatomical_constraints_sequence,
    apply_velocity_constraints,
    average_limb_lengths,
)

PRESET_CONFIGS: dict[str, dict[str, Any]] = {
    # 30 fps iPhone
    "smalliphone": {
        "window_size": 9,
        "poly_order": 2,
        "limb_length_tolerance": 0.05,
        "velocity_threshold": 50.0,
        "smoothing_method": "savgol",
    },
    # 60 fps iPhone
    "iphone": {
        "window_size": 13,
        "poly_order": 3,
        "limb_length_tolerance": 0.04,
        "velocity_threshold": 80.0,
        "smoothing_method": "savgol",
    },
    # Edgertronic 480 fps
    "edger": {
        "window_size": 31,
        "poly_order": 3,
        "limb_length_tolerance": 0.03,
        "velocity_threshold": 100.0,
        "smoothing_method": "savgol",
    },
}


def savgol_coefficients(window: int, polyorder: int) -> np.ndarray:
    """Central Savitzky-Golay FIR taps (scipy.signal.savgol_coeffs with
    use='conv' reversed, i.e. correlation order)."""
    if window % 2 == 0:
        raise ValueError("window must be odd")
    half = window // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    V = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    # Least-squares fit evaluated at the center: row 0 of pinv(V).
    return np.linalg.pinv(V)[0]


def _savgol_edge_operator(window: int, polyorder: int) -> np.ndarray:
    """(half, window) operator: polynomial fit over the first ``window``
    samples evaluated at positions 0..half-1 (scipy mode='interp')."""
    half = window // 2
    pos = np.arange(window, dtype=np.float64)
    V = pos[:, None] ** np.arange(polyorder + 1)[None, :]
    P = np.linalg.pinv(V)  # (p+1, window)
    E = pos[:half, None] ** np.arange(polyorder + 1)[None, :]  # (half, p+1)
    return E @ P


def _flat_float(x: torch.Tensor) -> torch.Tensor:
    """(T, ...) -> (T, F) in float64 for float64 input, else float32."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.reshape(x.shape[0], -1).to(dt)


def savgol_filter_time(x: torch.Tensor, window: int, polyorder: int) -> torch.Tensor:
    """Savitzky-Golay along axis 0 (time) of a (T, ...) tensor, T >= window,
    with scipy's 'interp' edges."""
    if window % 2 == 0:
        window += 1
    half = window // 2
    xf = _flat_float(x)
    taps = torch.as_tensor(savgol_coefficients(window, polyorder), dtype=xf.dtype, device=xf.device)
    E = torch.as_tensor(_savgol_edge_operator(window, polyorder), dtype=xf.dtype, device=xf.device)
    mid = (xf.unfold(0, window, 1) * taps).sum(-1)  # (T - window + 1, F)
    head = (E[:, :, None] * xf[None, :window]).sum(1)  # (half, F)
    tail = (E[:, :, None] * xf.flip(0)[None, :window]).sum(1).flip(0)
    return torch.cat([head, mid, tail], dim=0).reshape(x.shape)


def moving_average_time(x: torch.Tensor, window: int) -> torch.Tensor:
    """Centred moving average along axis 0; the first and last half-window
    samples keep their original values."""
    xf = _flat_float(x)
    T = xf.shape[0]
    half = window // 2
    out = xf.clone()
    sm = (xf.unfold(0, window, 1) * (1.0 / window)).sum(-1)  # sample i at row i - half
    out[half : T - half] = sm[: T - 2 * half]
    return out.reshape(x.shape)


def one_euro_filter_time(x: torch.Tensor, min_cutoff: float = 1.0, beta: float = 0.1) -> torch.Tensor:
    """One-Euro filter along axis 0 with dt = 1 frame: cutoff = min_cutoff
    + beta |dx|, alpha = 1 / (1 + 1 / cutoff), y = alpha x + (1 - alpha)
    y_prev."""
    xf = x.reshape(x.shape[0], -1)
    out = torch.empty_like(xf)
    out[0] = xf[0]
    prev_val, prev_filt = xf[0], xf[0]
    for t in range(1, xf.shape[0]):
        xi = xf[t]
        cutoff = min_cutoff + beta * torch.abs(xi - prev_val)
        alpha = 1.0 / (1.0 + 1.0 / cutoff)
        prev_filt = alpha * xi + (1.0 - alpha) * prev_filt
        prev_val = xi
        out[t] = prev_filt
    return out.reshape(x.shape)


def _filter(x: torch.Tensor, window: int, polyorder: int, method: str) -> torch.Tensor:
    if method == "savgol":
        return savgol_filter_time(x, window, polyorder)
    if method == "moving_average":
        return moving_average_time(x, window)
    if method == "one_euro":
        return one_euro_filter_time(x)
    raise ValueError(f"unknown smoothing method: {method}")


def _filter_with_nan_gaps(series: np.ndarray, window: int, polyorder: int, method: str,
                          device=None) -> np.ndarray:
    """The reference's NaN policy: compress the valid samples, filter,
    scatter back; too few valid samples leave the series as it is."""
    valid = np.isfinite(series)
    out = series.copy()
    idx = None
    dense = series
    if not valid.all():
        if valid.sum() < window:
            return out
        idx = np.flatnonzero(valid)
        dense = series[idx]
    sm = _filter(as_tensor(dense, device), window, polyorder, method).cpu().numpy()
    if idx is None:
        return sm
    out[idx] = sm
    return out


class MotionSmoother:
    """The reference MotionSmoother's surface on (T, J, 3) arrays; the
    filters and constraints run on ``device`` (None: the CUDA card)."""

    PRESET_CONFIGS = PRESET_CONFIGS

    def __init__(self, preset: str = "smalliphone", device=None, **kwargs: Any):
        self.config = dict(self.PRESET_CONFIGS.get(preset, self.PRESET_CONFIGS["smalliphone"]))
        self.config.update(kwargs)
        self.device = device
        self.pose_history: list[np.ndarray] = []
        self.reference_limb_lengths: np.ndarray | None = None
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> dict[str, float]:
        return {
            "frames_processed": 0,
            "anatomical_corrections": 0,
            "velocity_corrections": 0,
            "processing_time": 0.0,
        }

    def reset(self) -> None:
        self.pose_history = []
        self.reference_limb_lengths = None
        self.stats = self._fresh_stats()

    def get_stats(self) -> dict[str, float]:
        return self.stats

    def _smooth_trajectories(self, seq: np.ndarray) -> np.ndarray:
        """Filter every (joint, axis) trajectory of a (T, J, 3) sequence."""
        window = self.config["window_size"]
        if window % 2 == 0:
            window += 1
        poly = self.config["poly_order"]
        method = self.config["smoothing_method"]
        flat = seq.reshape(seq.shape[0], -1)
        if np.isfinite(flat).all():
            return _filter(as_tensor(seq, self.device), window, poly, method).cpu().numpy()
        out = np.empty_like(flat)
        for k in range(flat.shape[1]):
            out[:, k] = _filter_with_nan_gaps(flat[:, k], window, poly, method, self.device)
        return out.reshape(seq.shape)

    def smooth_pose_sequence(self, pose_sequence) -> np.ndarray:
        """Filter + anatomical + velocity constraints over a (T, J, 3) array:
        reference limb lengths measured on the unsmoothed sequence, then
        the filter, the anatomical and the velocity constraints."""
        seq = np.asarray(pose_sequence, np.float64)
        start = time.time()
        self.stats = self._fresh_stats()

        if seq.shape[0] < self.config["window_size"]:
            return seq

        ref_lengths = average_limb_lengths(seq, self.device)
        self.reference_limb_lengths = ref_lengths

        smoothed = self._smooth_trajectories(seq)
        smoothed, n_anat = apply_anatomical_constraints_sequence(
            smoothed, ref_lengths, tolerance=self.config["limb_length_tolerance"], device=self.device
        )
        smoothed, n_vel = apply_velocity_constraints(
            smoothed, velocity_threshold=self.config["velocity_threshold"], device=self.device
        )

        self.stats["frames_processed"] = int(seq.shape[0])
        self.stats["anatomical_corrections"] = int(n_anat)
        self.stats["velocity_corrections"] = int(n_vel)
        self.stats["processing_time"] = time.time() - start
        return smoothed

    def smooth_single_pose(self, pose, pose_history: list[np.ndarray] | None = None) -> np.ndarray:
        """Streaming form: smooth the trailing window once enough history
        exists, else apply the anatomical constraints with the default
        anthropometry."""
        if pose_history is not None:
            self.pose_history = list(pose_history)
        self.pose_history.append(np.asarray(pose, np.float64))
        w = self.config["window_size"]
        if len(self.pose_history) >= w:
            return self.smooth_pose_sequence(np.stack(self.pose_history[-w:]))[-1]
        constrained, n = apply_anatomical_constraints_sequence(
            np.asarray(pose, np.float64)[None], None,
            tolerance=self.config["limb_length_tolerance"], device=self.device,
        )
        self.stats["anatomical_corrections"] += int(n)
        return constrained[0]
