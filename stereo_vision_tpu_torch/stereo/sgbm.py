"""Semi-global block matching (cv2.StereoSGBM MODE_HH semantics) in PyTorch.

Port of ``stereo_vision_tpu/stereo/sgbm.py``. The cost stage and the
aggregation + WTA stage are the two kernel modules
(:mod:`.cost_cuda`, :mod:`.sgm_cuda`), whose plain forms hold the scan
reference (``_xsobel_clipped``, ``_bt_channel_cost``, ``_box_filter_same``,
``_sgm_update``, ``_aggregate_down``, ``_aggregate_horiz``, ``_aggregate_8``,
``wta_scan``);
this module composes them with the subpixel parabola, the LR check
(:func:`lr_fail` here is its plain form, :func:`.lr_cuda.lr_fail` the
kernel's wrapper) and the speckle filter (:mod:`.speckle_cuda`). The
tensors' device decides where everything runs: CUDA tensors launch the
kernels, CPU tensors run the plain forms.

Images are (H, W) or (B, H, W) 8-bit intensities (any integer dtype); a
batch of frames runs in one set of kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_vision_tpu_torch.stereo.cost_cuda import (
    _box_filter_same,
    compute_pixel_cost as _pixel_cost,
    cost_volume,
    window_bound,
)
from stereo_vision_tpu_torch.stereo.sgm_cuda import _aggregate_8, sgm_reduce, storage_dtype
from stereo_vision_tpu_torch.stereo.speckle_cuda import speckle_filter


class StereoSGBMParams(NamedTuple):
    """``stereo_vision_tpu.stereo.sgbm.StereoSGBMParams`` without
    ``backend``: the tensors' device picks the implementation."""

    min_disparity: int = 0
    num_disparities: int = 128
    block_size: int = 5
    p1: int | None = None          # default 8 * block_size**2
    p2: int | None = None          # default 32 * block_size**2
    disp12_max_diff: int = -1      # <0 disables the LR check
    prefilter_cap: int = 15        # cv2: ftzero = max(preFilterCap, 15) | 1
    uniqueness_ratio: int = 0
    speckle_window_size: int = 0   # 0 disables
    speckle_range: int = 0
    num_paths: int = 8             # 8 = MODE_HH; 4/3/2 = fewer directions

    @property
    def P1(self) -> int:
        # An explicit 0 stays 0 (pure WTA), as cv2 honours P1=0.
        return self.p1 if self.p1 is not None else 8 * self.block_size * self.block_size

    @property
    def P2(self) -> int:
        return self.p2 if self.p2 is not None else 32 * self.block_size * self.block_size

    @property
    def ftzero(self) -> int:
        return max(self.prefilter_cap, 15) | 1

    @property
    def cost_bound(self) -> int:
        """Upper bound of a windowed cost for 8-bit images."""
        return window_bound(self.block_size, self.ftzero)


def compute_pixel_cost(left, right, params: StereoSGBMParams) -> torch.Tensor:
    """(..., H, W, D) per-pixel (unwindowed) BT cost (sobel + raw>>2)."""
    return _pixel_cost(left, right, ndisp=params.num_disparities, mindisp=params.min_disparity,
                       ftzero=params.ftzero, block_size=params.block_size)


def compute_cost_volume(left, right, params: StereoSGBMParams) -> torch.Tensor:
    """(..., H, W, D) windowed BT cost (sobel channel + raw>>2 channel)."""
    return _box_filter_same(compute_pixel_cost(left, right, params), params.block_size)


def _as_batch(a: torch.Tensor) -> torch.Tensor:
    if a.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(a.shape)}")
    return a.to(torch.int32).reshape(-1, *a.shape[-2:]).contiguous()


def sgbm_stats(left, right, params: StereoSGBMParams, min_x: int | None = None):
    """Cost build + aggregation + WTA on columns ``x >= min_x``.

    Returns ``(minS, best, sm, s0, sp, unique_ok)``: int32/bool maps of
    shape (B, H, W - min_x) for (B, H, W) inputs. The cost volume is built
    in the type the aggregation stores (:func:`.sgm_cuda.storage_dtype`).
    """
    maxD = params.min_disparity + params.num_disparities
    minX1 = max(maxD, 0) if min_x is None else int(min_x)
    C = cost_volume(
        _as_batch(left), _as_batch(right), ndisp=params.num_disparities,
        mindisp=params.min_disparity, block_size=params.block_size,
        ftzero=params.ftzero, x_offset=minX1,
        dtype=storage_dtype(params.cost_bound, params.P2, 3 if params.num_paths >= 8 else 1),
    )
    return sgm_reduce(C, params.P1, params.P2, params.uniqueness_ratio,
                      cost_bound=params.cost_bound, num_paths=params.num_paths)


def subpixel_disp16(best, sm, s0, sp, ndisp: int) -> torch.Tensor:
    """cv2 subpixel parabola in 1/16 px (int32):
    d*16 + ((S[d-1]-S[d+1])*16 + denom2) / (denom2*2) with C (truncating)
    integer division; the edges d = 0 and D-1 keep d*16."""
    denom2 = torch.clamp(sm + sp - 2 * s0, min=1)
    num = (sm - sp) * 16 + denom2
    q = torch.div(num, 2 * denom2, rounding_mode="trunc")
    inner = (best > 0) & (best < ndisp - 1)
    return torch.where(inner, best * 16 + q, best * 16).to(torch.int32)


def lr_fail(minS, best, disp, *, W: int, min_x: int, ndisp: int, mindisp: int, max_diff: int) -> torch.Tensor:
    """cv2 LR-consistency failure mask on (B, H, Wv) valid-region maps (the
    plain form of :func:`.lr_cuda.lr_fail`).

    ``best`` is the integer WTA disparity (without mindisp), ``disp`` the
    float disparity (with mindisp); ``ndisp`` is the full range. The right
    view's disparity is cv2's packed projection: disp2[x2] is the winner d
    of minimal cost among left pixels x = x2 + d whose winner is d.
    """
    B, H, Wv = minS.shape
    maxD = mindisp + ndisp
    if ndisp + abs(mindisp) >= 1 << 11:
        raise ValueError("disparity range exceeds the 11-bit pack field")
    if mindisp < 0:
        raise ValueError("the LR check assumes min_disparity >= 0")
    dev = minS.device
    pack = minS.to(torch.int32) * (1 << 11) + (best.to(torch.int32) + mindisp)
    sentinel = 1 << 30
    pack_full = torch.full((B, H, W + maxD), sentinel, dtype=torch.int32, device=dev)
    pack_full[..., min_x : min_x + Wv] = pack
    best_full = torch.full((B, H, W + maxD), -1, dtype=torch.int32, device=dev)
    best_full[..., min_x : min_x + Wv] = best
    packed = torch.full((B, H, W), sentinel, dtype=torch.int32, device=dev)
    for d in range(ndisp):
        off = d + mindisp
        hit = best_full[..., off : off + W] == d
        packed = torch.minimum(packed, torch.where(hit, pack_full[..., off : off + W], sentinel))
    disp2 = torch.where(packed >= sentinel, -(1 << 10), packed & ((1 << 11) - 1))

    d_f = torch.floor(disp).to(torch.int32)
    d_c = torch.ceil(disp).to(torch.int32)
    oob = -(1 << 10)
    padl = maxD + 1
    d2p = torch.cat([
        torch.full((B, H, padl), oob, dtype=torch.int32, device=dev), disp2,
        torch.full((B, H, 1), oob, dtype=torch.int32, device=dev),
    ], dim=-1)
    v_f = torch.full((B, H, Wv), oob, dtype=torch.int32, device=dev)
    v_c = v_f.clone()
    for dd in range(mindisp - 1, maxD + 1):
        # valid column x_v sits at full-frame x = x_v + min_x
        sh = d2p[..., padl + min_x - dd : padl + min_x - dd + Wv]
        v_f = torch.where(d_f == dd, sh, v_f)
        v_c = torch.where(d_c == dd, sh, v_c)
    fail_f = (v_f >= mindisp) & ((v_f - d_f).abs() > max_diff)
    fail_c = (v_c >= mindisp) & ((v_c - d_c).abs() > max_diff)
    return fail_f & fail_c


def stereo_sgbm(left, right, params: StereoSGBMParams = StereoSGBMParams()) -> torch.Tensor:
    """Dense SGBM disparity (cv2.StereoSGBM MODE_HH semantics).

    Args:
      left, right: (H, W) or (B, H, W) rectified 8-bit pairs.

    Returns:
      float32 disparity of the input's shape; invalid = ``min_disparity - 1``.
    """
    squeeze = left.dim() == 2
    left, right = _as_batch(left), _as_batch(right)
    B, H, W = left.shape
    ndisp = params.num_disparities
    mindisp = params.min_disparity
    minX1 = max(mindisp + ndisp, 0)
    invalid_val = float(mindisp - 1)
    if minX1 >= W:
        # No column sees the full disparity range: the reference's map is all
        # invalid (its speckle filter leaves invalid pixels as they are), and
        # no kernel runs on the empty region.
        full = torch.full((B, H, W), invalid_val, dtype=torch.float32, device=left.device)
        return full[0] if squeeze else full

    minS, best, sm, s0, sp, unique_ok = sgbm_stats(left, right, params)
    disp = subpixel_disp16(best, sm, s0, sp, ndisp).to(torch.float32) / 16.0 + mindisp

    valid = unique_ok
    if params.disp12_max_diff >= 0:
        # lr_cuda imports this module (its plain form is lr_fail above).
        from stereo_vision_tpu_torch.stereo import lr_cuda

        valid = valid & ~lr_cuda.lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=ndisp,
                                         mindisp=mindisp, max_diff=params.disp12_max_diff)
    full = torch.full((B, H, W), invalid_val, dtype=torch.float32, device=left.device)
    full[..., minX1:] = torch.where(valid, disp, invalid_val)

    if params.speckle_window_size > 0:
        full = speckle_filter(full, max_diff=float(params.speckle_range),
                              max_speckle_size=params.speckle_window_size,
                              invalid_value=invalid_val)
    return full[0] if squeeze else full
