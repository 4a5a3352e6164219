"""Content-based and timestamp-based frame matching.

Port of ``stereo_vision_tpu/sync/matching.py``: PSNR frame similarity with a
sliding-window offset search, and timestamp-proximity pairing with a
maximum time difference. The whole (T_left x T_right) similarity matrix is
one device computation.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.sync.flash import match_offset_by_timestamps


def frame_similarity(a, b, device=None) -> torch.Tensor:
    """PSNR between two same-shape grayscale frames (higher = more
    similar), MAX_I = 255, as cv2.PSNR; a float32 scalar tensor."""
    af = as_tensor(a, device).to(torch.float32)
    bf = as_tensor(b, af.device).to(torch.float32)
    mse = torch.clamp(torch.mean((af - bf) ** 2), min=1e-10)
    return 10.0 * torch.log10(255.0**2 / mse)


def similarity_matrix(left, right, device=None) -> torch.Tensor:
    """(Tl, Tr) float32 PSNR matrix between two grayscale frame stacks
    (Tl, H, W) and (Tr, H, W) of the same spatial size.

    mse[i, j] = mean(l_i^2) + mean(r_j^2) - 2 mean(l_i r_j), in float32 as
    the reference computes it, but the cross term is one float64 matrix
    product (exact for integer frames below 2^53 / 255^2 pixels), rounded
    to float32: no TF32 setting applies to it, and the card and the CPU
    get the same value.
    """
    lf = as_tensor(left, device).to(torch.float32)
    rf = as_tensor(right, lf.device).to(torch.float32)
    p = lf.shape[1] * lf.shape[2]
    lflat, rflat = lf.reshape(lf.shape[0], -1), rf.reshape(rf.shape[0], -1)
    l2 = torch.mean(lflat**2, dim=1)
    r2 = torch.mean(rflat**2, dim=1)
    cross = (lflat.to(torch.float64) @ rflat.to(torch.float64).T).to(torch.float32) / p
    mse = torch.clamp(l2[:, None] + r2[None, :] - 2.0 * cross, min=1e-10)
    return 10.0 * torch.log10(255.0**2 / mse)


def find_best_offset_by_content(left, right, search_window: int = 30, device=None) -> tuple[int, float]:
    """Best integer frame offset by average PSNR along the aligned diagonal:
    one similarity matrix on the device, the diagonal means on the host.

    Returns:
      (offset, score): add ``offset`` to a left index to get the matching
      right index; score is the mean PSNR of the aligned overlap.
    """
    sim = similarity_matrix(left, right, device).cpu().numpy()
    tl, tr = sim.shape
    best_off, best_score = 0, -np.inf
    for off in range(-search_window, search_window + 1):
        li = np.arange(max(0, -off), min(tl, tr - off))
        if len(li) == 0:
            continue
        score = sim[li, li + off].mean()
        if score > best_score:
            best_score, best_off = float(score), off
    return best_off, best_score


def match_frames_by_timestamp(
    left_ts: np.ndarray,
    right_ts: np.ndarray,
    max_time_diff: float = 0.1,
    search: int = 20,
) -> list[tuple[int, int]]:
    """Timestamp-proximity frame pairing (host numpy).

    Finds the best integer offset over +-``search`` frames, then pairs
    aligned frames whose |dt| <= ``max_time_diff``; falls back to identity
    pairing when nothing matches.
    """
    left_ts = np.asarray(left_ts, np.float64)
    right_ts = np.asarray(right_ts, np.float64)
    off = match_offset_by_timestamps(left_ts, right_ts, search=search)
    li0, ri0 = (abs(off), 0) if off < 0 else (0, off)
    n = min(len(left_ts) - li0, len(right_ts) - ri0)
    pairs = []
    for i in range(n):
        if abs(left_ts[li0 + i] - right_ts[ri0 + i]) <= max_time_diff:
            pairs.append((li0 + i, ri0 + i))
    if not pairs:
        pairs = [(i, i) for i in range(min(len(left_ts), len(right_ts)))]
    return pairs
