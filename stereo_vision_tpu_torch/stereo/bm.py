"""Block-matching dense stereo (cv2.StereoBM semantics) in PyTorch.

Port of ``stereo_vision_tpu/stereo/bm.py``: the x-Sobel prefilter, the SAD
cost volume over a ``block_size`` window, texture threshold, winner-take-all,
the integer uniqueness check and cv2's modified-parabola subpixel step. The
pieces here are the plain forms (the XLA path of the JAX module); the matcher
itself is one kernel, :func:`.bm_cuda.bm_disparity`, which launches
``csrc/bm.cu`` for CUDA tensors and runs :func:`valid_disparity_plain` for CPU
ones. The tensors' device decides; a batch of frames runs in one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StereoBMParams(NamedTuple):
    """``stereo_vision_tpu.stereo.bm.StereoBMParams`` without ``backend``:
    the tensors' device picks the implementation."""

    num_disparities: int = 64
    block_size: int = 15
    min_disparity: int = 0
    prefilter_cap: int = 31
    texture_threshold: int = 10
    uniqueness_ratio: int = 15


def _replicate_shift(a: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """``a`` moved by one along ``dim`` with the edge replicated: step +1
    takes the previous element (a[i-1]), -1 the next (a[i+1])."""
    n = a.shape[dim]
    if step > 0:
        return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim=dim)
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim=dim)


def prefilter_xsobel(img: torch.Tensor, cap: int = 31) -> torch.Tensor:
    """cv2 BM x-Sobel prefilter of (..., H, W) images: clip(sobel_x + cap, 0,
    2*cap), int32. Border columns are ``cap``; rows replicate their edge."""
    img = img.to(torch.int32)
    up, down = _replicate_shift(img, -2, 1), _replicate_shift(img, -2, -1)
    d0 = _replicate_shift(up, -1, -1) - _replicate_shift(up, -1, 1)
    d1 = _replicate_shift(img, -1, -1) - _replicate_shift(img, -1, 1)
    d2 = _replicate_shift(down, -1, -1) - _replicate_shift(down, -1, 1)
    v = torch.clamp(d0 + 2 * d1 + d2 + cap, 0, 2 * cap)
    v[..., 0] = cap
    v[..., -1] = cap
    return v


def _box_sum_valid(x: torch.Tensor, bs: int) -> torch.Tensor:
    """Integer bs x bs box sum over the last two axes, 'valid' size:
    (..., H, W) -> (..., H-bs+1, W-bs+1)."""
    Ho, Wo = x.shape[-2] - bs + 1, x.shape[-1] - bs + 1
    y = x[..., 0:Ho, :]
    for k in range(1, bs):
        y = y + x[..., k : k + Ho, :]
    out = y[..., :, 0:Wo]
    for k in range(1, bs):
        out = out + y[..., :, k : k + Wo]
    return out


def _sad_cost_volume(lp: torch.Tensor, rp: torch.Tensor, ndisp: int, mindisp: int, bs: int) -> torch.Tensor:
    """(..., D, H', W') SAD cost volume of (..., H, W) prefiltered images.

    cost[d, y, x] is the window SAD between the left image at x and the
    right image at x - s, s = max(mindisp + d, 0), with zeros left of the
    frame (the JAX path's zero pad + clamped ``dynamic_slice``); (y, x) are
    window left/top edges, so centres sit bs // 2 further in."""
    W = lp.shape[-1]
    diffs = torch.empty((*lp.shape[:-2], ndisp, *lp.shape[-2:]), dtype=torch.int32, device=lp.device)
    for d in range(ndisp):
        s = min(max(mindisp + d, 0), W)
        shifted = torch.zeros_like(rp)
        shifted[..., s:] = rp[..., : W - s]
        diffs[..., d, :, :] = (lp - shifted).abs()
    return _box_sum_valid(diffs, bs)


def valid_disparity_plain(lp: torch.Tensor, rp: torch.Tensor, *, ndisp: int, mindisp: int, block_size: int, cap: int,
                          uniq: int, tex_thr: int) -> torch.Tensor:
    """Plain form of :func:`.bm_cuda.bm_disparity`: (B, H, W) prefiltered
    int32 images -> (B, H-bs+1, W-bs+1) float32 disparity of the window
    centres, invalid = ``mindisp - 1`` (texture, uniqueness, left range)."""
    bs = block_size
    cost = _sad_cost_volume(lp.to(torch.int32), rp.to(torch.int32), ndisp, mindisp, bs)  # (B, D, H', W')
    minsad, mind = cost.min(dim=-3)  # ties -> the smallest d
    tex_ok = _box_sum_valid((lp.to(torch.int32) - cap).abs(), bs) >= tex_thr

    # Uniqueness in cv2's integers: any d with cost <= minsad + minsad*U//100
    # and |d - best| > 1 invalidates the pixel.
    thresh = minsad + torch.div(minsad * uniq, 100, rounding_mode="floor")
    ds = torch.arange(ndisp, device=lp.device).reshape(ndisp, 1, 1)
    offender = (cost <= thresh.unsqueeze(-3)) & ((ds - mind.unsqueeze(-3)).abs() > 1)
    unique_ok = ~offender.any(dim=-3)

    # cv2's modified parabola on the integer SADs (delta = 0 at the range's
    # ends; the samples there only need to be in bounds).
    d0 = mind.clamp(1, ndisp - 2)
    take = lambda i: torch.gather(cost, -3, i.clamp(0, ndisp - 1).unsqueeze(-3)).squeeze(-3)
    c0, cn, cp = take(d0), take(d0 - 1), take(d0 + 1)
    denom = cp + cn - 2 * c0 + (cp - cn).abs()
    delta = torch.where(denom != 0, (cn - cp) / denom, 0.0)
    delta = torch.where((mind > 0) & (mind < ndisp - 1), delta, 0.0)
    disp = (mind + mindisp).to(torch.float32) + delta.to(torch.float32)

    # Left margin: the whole disparity range in frame for the whole window.
    Wv = cost.shape[-1]
    range_ok = torch.arange(Wv, device=lp.device) - (mindisp + ndisp - 1) >= 0
    valid = tex_ok & unique_ok & range_ok
    return torch.where(valid, disp, float(mindisp - 1))


def stereo_bm(left, right, params: StereoBMParams = StereoBMParams()) -> torch.Tensor:
    """Dense block-matching disparity (cv2.StereoBM semantics).

    Args:
      left, right: (H, W) or (B, H, W) rectified 8-bit pairs (any integer dtype).

    Returns:
      float32 disparity of the input's shape; invalid = ``min_disparity - 1``.
    """
    # bm_cuda imports this module (its plain form is valid_disparity_plain).
    from stereo_vision_tpu_torch.stereo.bm_cuda import bm_disparity

    if left.dim() not in (2, 3) or left.shape != right.shape:
        raise ValueError(f"expected two (H, W) or (B, H, W) images of one shape, got {tuple(left.shape)}, "
                         f"{tuple(right.shape)}")
    squeeze = left.dim() == 2
    left, right = left.reshape(-1, *left.shape[-2:]), right.reshape(-1, *right.shape[-2:])
    B, H, W = left.shape
    bs, mindisp = params.block_size, params.min_disparity
    if bs < 1:
        raise ValueError(f"block_size must be >= 1, got {bs}")
    full = torch.full((B, H, W), float(mindisp - 1), dtype=torch.float32, device=left.device)
    if H < bs or W < bs:
        # No window fits the frame: the reference's map is all invalid, and
        # no kernel runs.
        return full[0] if squeeze else full
    lp = prefilter_xsobel(left, params.prefilter_cap).contiguous()
    rp = prefilter_xsobel(right, params.prefilter_cap).contiguous()
    disp_v = bm_disparity(lp, rp, ndisp=params.num_disparities, mindisp=mindisp, block_size=bs,
                          cap=params.prefilter_cap, uniq=params.uniqueness_ratio, tex_thr=params.texture_threshold)
    # Paste the window-centre region back into full-frame coordinates.
    wsz2 = bs // 2
    full[:, wsz2 : wsz2 + disp_v.shape[1], wsz2 : wsz2 + disp_v.shape[2]] = disp_v
    return full[0] if squeeze else full
