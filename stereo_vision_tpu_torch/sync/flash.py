"""Flash-pulse synchronization as batched reductions.

Port of ``stereo_vision_tpu/sync/flash.py`` (the reference's adaptive flash
detector):

  1. Per-frame mean grayscale brightness.
  2. Adaptive threshold from ~30 sampled frames: max(15, 3*std), scaled
     0.8x (floor 10) for dark videos (mean < 50) and 1.5x for bright videos
     (mean > 200).
  3. Flash = first frame whose brightness exceeds the trailing
     ``window_size``-frame mean by more than the threshold.
  4. Stereo offset = right_flash - left_flash.

The brightness series is one reduction over a (T, H, W[, 3]) batch on the
device and the jump test a vectorized trailing-window comparison, in
float32 as the reference computes them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor

# ITU-R BT.601 luma weights, matching cv2.cvtColor(BGR2GRAY). Channel order
# here is RGB; callers with BGR frames should flip the last axis first.
_LUMA_RGB = (0.299, 0.587, 0.114)


def frame_brightness(frames, device=None) -> torch.Tensor:
    """(T,) float32 mean grayscale brightness of (T, H, W) grayscale or
    (T, H, W, 3) RGB frames of any integer or float dtype, on ``device``
    (None = the CUDA card; a tensor stays on its device). RGB takes the
    luma weights as a sum of products, no matrix multiply."""
    f = as_tensor(frames, device).to(torch.float32)
    if f.ndim == 4:
        w = torch.tensor(_LUMA_RGB, dtype=torch.float32, device=f.device)
        f = f[..., 0] * w[0] + f[..., 1] * w[1] + f[..., 2] * w[2]
    return f.mean(dim=(1, 2))


def adaptive_flash_threshold(
    brightness,
    base_threshold: float = 20.0,
    sample_stride: int = 10,
    num_samples: int = 30,
    min_samples: int = 10,
    device=None,
) -> torch.Tensor:
    """Adaptive threshold (a float32 scalar tensor) from the reference's
    sampling rule.

    Samples every ``sample_stride``-th frame (up to ``num_samples``), then
    threshold = max(15, 3*std) (the population std); *0.8 with floor 10 if
    mean < 50; *1.5 if mean > 200. Falls back to ``base_threshold`` when
    fewer than ``min_samples`` samples are available.
    """
    b = as_tensor(brightness, device)
    sampled = b[::sample_stride][:num_samples]
    if sampled.shape[0] < min_samples:
        return torch.tensor(base_threshold, dtype=torch.float32, device=b.device)
    if not sampled.dtype.is_floating_point:
        sampled = sampled.to(torch.float32)
    avg = sampled.mean()
    thr = torch.clamp(3.0 * sampled.std(correction=0), min=15.0)
    thr = torch.where(avg < 50.0, torch.clamp(thr * 0.8, min=10.0), thr)
    return torch.where(avg > 200.0, thr * 1.5, thr).to(torch.float32)


def _trailing_mean(brightness: torch.Tensor, window_size: int) -> torch.Tensor:
    """Mean of the ``window_size`` frames strictly before each frame; +inf
    where fewer than ``window_size`` frames precede it (the reference tests
    only once the history is full)."""
    c = torch.cat([brightness.new_zeros(1), torch.cumsum(brightness, 0)])
    idx = torch.arange(brightness.shape[0], device=brightness.device)
    lo = idx - window_size
    win = (c[idx] - c[torch.clamp(lo, min=0)]) / window_size
    return torch.where(lo >= 0, win, torch.inf)


def _flash_index(brightness: torch.Tensor, threshold: torch.Tensor, window_size: int = 5):
    """(first jump index, whether any frame jumps, the trailing means)."""
    prev_avg = _trailing_mean(brightness, window_size)
    jump = brightness > prev_avg + threshold
    # argmax over integers returns the first maximum, as jnp.argmax on bools.
    return torch.argmax(jump.to(torch.int32)), jump.any(), prev_avg


def detect_flash(
    frames_or_brightness,
    threshold: float | None = None,
    window_size: int = 5,
    max_frames: int = 900,
    device=None,
) -> int | None:
    """First flash frame in a stream, or None.

    Args:
      frames_or_brightness: (T, H, W[, 3]) frames or a precomputed (T,)
        brightness series.
      threshold: fixed jump threshold; None selects the adaptive rule.
      window_size: trailing baseline window (the reference's default 5).
      max_frames: scan limit (default 900 = 30 s at 30 fps).
      device: None = the CUDA card; a tensor stays on its device.
    """
    arr = as_tensor(frames_or_brightness, device)
    b = arr if arr.ndim == 1 else frame_brightness(arr)
    b = b[:max_frames]
    if threshold is None:
        thr = adaptive_flash_threshold(b)
    else:
        thr = torch.tensor(threshold, dtype=torch.float32, device=b.device)
    idx, found, _ = _flash_index(b, thr, window_size)
    return int(idx) if bool(found) else None


class FlashSyncResult(NamedTuple):
    left_flash: int | None
    right_flash: int | None
    offset: int | None  # right_flash - left_flash
    threshold_left: float
    threshold_right: float


def compute_sync_offset(left_flash: int | None, right_flash: int | None) -> int | None:
    """Frame offset to add to left indices to land on the matching right
    frame (offset = right_flash - left_flash)."""
    if left_flash is None or right_flash is None:
        return None
    return int(right_flash) - int(left_flash)


def synchronize_streams(
    left_frames,
    right_frames,
    threshold: float | None = None,
    window_size: int = 5,
    max_frames: int = 900,
    device=None,
) -> FlashSyncResult:
    """Full flash-sync of two streams on ``device`` (None = the CUDA card)."""
    lb = frame_brightness(left_frames, device)[:max_frames]
    rb = frame_brightness(right_frames, lb.device)[:max_frames]
    if threshold is None:
        lt = float(adaptive_flash_threshold(lb))
        rt = float(adaptive_flash_threshold(rb))
    else:
        lt = rt = float(threshold)
    li, lf, _ = _flash_index(lb, torch.tensor(lt, dtype=torch.float32, device=lb.device), window_size)
    ri, rf, _ = _flash_index(rb, torch.tensor(rt, dtype=torch.float32, device=rb.device), window_size)
    left = int(li) if bool(lf) else None
    right = int(ri) if bool(rf) else None
    return FlashSyncResult(
        left_flash=left,
        right_flash=right,
        offset=compute_sync_offset(left, right),
        threshold_left=lt,
        threshold_right=rt,
    )


def match_offset_by_timestamps(
    left_ts: np.ndarray,
    right_ts: np.ndarray,
    search: int = 20,
    probe: int = 10,
) -> int:
    """Timestamp-based offset search (host numpy).

    Tries integer offsets in [-search, search]; for each, averages the
    |dt| over the first ``probe`` aligned frames; returns the argmin offset
    (positive offset = right starts later).
    """
    left_ts = np.asarray(left_ts, np.float64)
    right_ts = np.asarray(right_ts, np.float64)
    best_offset, min_diff = 0, np.inf
    for offset in range(-search, search + 1):
        if offset < 0:
            li, ri = -offset, 0
        else:
            li, ri = 0, offset
        n = min(probe, len(left_ts) - li, len(right_ts) - ri)
        if n <= 0:
            continue
        d = np.abs(left_ts[li : li + n] - right_ts[ri : ri + n]).mean()
        if d < min_diff:
            min_diff, best_offset = d, offset
    return best_offset
