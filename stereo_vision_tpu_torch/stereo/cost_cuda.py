"""Windowed Birchfield-Tomasi cost volume: plain PyTorch form + CUDA kernel.

Replaces ``stereo_vision_tpu/stereo/cost_pallas.py::cost_volume_pallas``
(kernel body ``_cost_kernel``). The kernel is ``csrc/cost.cu``; the plain
form below repeats the JAX reference ``stereo/sgbm.py::compute_cost_volume``
(clipped x-Sobel channel + raw channel >> 2, BT half-sample extrema, a
``block_size``-square box sum with replicate borders) and is what runs for
CPU tensors and what the kernel is held against on the card.

Value bounds (8-bit intensities): the Sobel channel lies in
``[0, 2*ftzero]`` and the raw channel's BT cost is <= 255, so one pixel
costs <= ``2*ftzero + 63`` (93 at ftzero 15) and a window <= ``block_size^2``
times that (:func:`window_bound`). The kernel writes int16 where the window
fits it and int32 otherwise, or the type its caller asks for (the SGM scans
need int32 volumes before the costs do).

A negative ``min_disparity`` follows the JAX reference, whose right row is
sliced with ``jax.lax.dynamic_slice``: the slice start is clamped, so every
plane d with ``min_disparity + d < 0`` is the plane of shift 0.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # left, right, out, B, H, W, D, mindisp, block_size, ftzero, x_offset, out_bytes, stream
    "svt_cost_volume": [_P, _P, _P] + [_I] * 9 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.library("cost")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    # D, block_size -> bytes of shared memory a block of the kernel needs
    fn = lib.svt_cost_volume_smem
    fn.argtypes, fn.restype = [_I, _I], ctypes.c_longlong
    return lib


def window_bound(block_size: int, ftzero: int) -> int:
    """Upper bound of a windowed cost for 8-bit images."""
    return block_size * block_size * (2 * ftzero + 63)


def cost_dtype(block_size: int, ftzero: int, dtype: torch.dtype | None = None) -> torch.dtype:
    """``dtype`` (int16 or int32), or by default int16 where
    :func:`window_bound` fits it and int32 otherwise."""
    if dtype is None:
        return torch.int16 if window_bound(block_size, ftzero) < 1 << 15 else torch.int32
    if dtype not in (torch.int16, torch.int32):
        raise TypeError(f"a cost volume is int16 or int32, not {dtype}")
    return dtype


def _xsobel_clipped(img: torch.Tensor, ftzero: int) -> torch.Tensor:
    """SGBM's row Sobel on (..., H, W): clip(dx, -ftzero, ftzero) + ftzero;
    columns 0 and W-1 are ftzero."""
    img = img.to(torch.int32)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)

    def dx(a):
        l = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
        r = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
        return r - l

    v = (2 * dx(img) + dx(up) + dx(down)).clamp(-ftzero, ftzero) + ftzero
    v[..., 0] = ftzero
    v[..., -1] = ftzero
    return v


def _half_extrema(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """BT half-sample extrema along the last axis. The edge-replicated
    neighbour reproduces cv2's rule (no left half-sample at x=0, no right
    one at W-1): (a + a) // 2 == a."""
    left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    vl = torch.div(a + left, 2, rounding_mode="floor")
    vr = torch.div(a + right, 2, rounding_mode="floor")
    v0 = torch.minimum(torch.minimum(vl, vr), a)
    v1 = torch.maximum(torch.maximum(vl, vr), a)
    return v0, v1


def _bt_channel_cost(p1row: torch.Tensor, p2row: torch.Tensor, ndisp: int, mindisp: int) -> torch.Tensor:
    """(..., H, W, D) int16 BT cost: cost[..., y, x, d] =
    BT(left[y, x], right[y, x - max(d + mindisp, 0)]).

    The right row is edge-padded on the left by ``mindisp + ndisp - 1``
    BEFORE its half-extrema are taken, so samples left of column 0 behave
    as a replicated constant signal (the JAX reference's convention). A
    shift below 0 is clamped to 0, as the reference's ``dynamic_slice``
    clamps its start; a range that ends below 0 has no padding and is
    refused (the reference's ``jnp.pad`` fails there)."""
    W = p1row.shape[-1]
    u0, u1 = _half_extrema(p1row)
    maxshift = mindisp + ndisp - 1
    if maxshift < 0:
        raise ValueError(f"min_disparity {mindisp} + ndisp {ndisp} leaves no disparity >= 0")
    v_p = torch.cat([p2row[..., :1].expand(*p2row.shape[:-1], maxshift), p2row], dim=-1)
    v0_p, v1_p = _half_extrema(v_p)
    out = torch.empty((*p1row.shape, ndisp), dtype=torch.int16, device=p1row.device)
    for d in range(ndisp):
        off = maxshift - max(mindisp + d, 0)
        v, vv0, vv1 = (a[..., off : off + W] for a in (v_p, v0_p, v1_p))
        c0 = torch.maximum((p1row - vv1).clamp(min=0), vv0 - p1row)
        c1 = torch.maximum((v - u1).clamp(min=0), u0 - v)
        out[..., d] = torch.minimum(c0, c1)
    return out


def _box_filter_same(x: torch.Tensor, bs: int) -> torch.Tensor:
    """bs x bs box sum over axes (-3, -2) of (..., H, W, D), replicate-padded
    (cv2 clamp), accumulated in the input dtype."""
    r = bs // 2
    H, W = x.shape[-3], x.shape[-2]
    xp = torch.cat([x[..., :1, :, :]] * r + [x] + [x[..., -1:, :, :]] * r, dim=-3)
    y = xp[..., 0:H, :, :].clone()
    for k in range(1, bs):
        y += xp[..., k : k + H, :, :]
    yp = torch.cat([y[..., :1, :]] * r + [y] + [y[..., -1:, :]] * r, dim=-2)
    out = yp[..., 0:W, :].clone()
    for k in range(1, bs):
        out += yp[..., k : k + W, :]
    return out


def compute_pixel_cost(left, right, *, ndisp: int, mindisp: int, ftzero: int, block_size: int) -> torch.Tensor:
    """(..., H, W, D) per-pixel (unwindowed) cost: sobel BT + (raw BT >> 2)."""
    ls = _xsobel_clipped(left, ftzero)
    rs = _xsobel_clipped(right, ftzero)
    c_sobel = _bt_channel_cost(ls, rs, ndisp, mindisp)
    c_raw = _bt_channel_cost(left.to(torch.int32), right.to(torch.int32), ndisp, mindisp)
    pix = c_sobel + (c_raw >> 2)
    if block_size > 11:  # bs^2 * 93 would overflow int16
        pix = pix.to(torch.int32)
    return pix


def cost_volume_plain(
    left: torch.Tensor, right: torch.Tensor, *, ndisp: int, mindisp: int = 0,
    block_size: int = 5, ftzero: int = 15, x_offset: int = 0,
) -> torch.Tensor:
    """Plain form of :func:`cost_volume`: the full-width windowed cost,
    sliced at ``x_offset`` after the box (borders clamp over full width)."""
    pix = compute_pixel_cost(left, right, ndisp=ndisp, mindisp=mindisp, ftzero=ftzero, block_size=block_size)
    return _box_filter_same(pix, block_size)[..., x_offset:, :].contiguous()


def cost_volume(
    left: torch.Tensor, right: torch.Tensor, *, ndisp: int, mindisp: int = 0,
    block_size: int = 5, ftzero: int = 15, x_offset: int = 0, dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(B, H, W) int32 image pairs -> (B, H, W - x_offset, ndisp) windowed
    cost for columns x >= x_offset, of ``dtype`` (default: int16 where
    :func:`window_bound` fits it, else int32).

    CUDA tensors launch ``csrc/cost.cu`` (odd ``block_size`` whose block
    fits the device's shared memory, ``ndisp`` <= 256); CPU tensors run
    :func:`cost_volume_plain`.
    """
    if left.shape != right.shape or left.dim() != 3:
        raise ValueError(f"expected two (B, H, W) images, got {tuple(left.shape)} and {tuple(right.shape)}")
    if left.dtype != torch.int32 or right.dtype != torch.int32:
        raise TypeError("cost_volume takes int32 images")
    if left.device != right.device:
        raise ValueError("left and right lie on different devices")
    B, H, W = left.shape
    if not 0 <= x_offset < W or ndisp < 1 or mindisp + ndisp < 1:
        raise ValueError(f"bad x_offset={x_offset} / min_disparity={mindisp} / ndisp={ndisp} for width {W}")
    if block_size % 2 != 1 or block_size < 1:
        raise ValueError(f"block_size must be odd and >= 1, got {block_size}")
    dtype = cost_dtype(block_size, ftzero, dtype)
    if left.device.type == "cpu":
        return cost_volume_plain(left, right, ndisp=ndisp, mindisp=mindisp, block_size=block_size,
                                 ftzero=ftzero, x_offset=x_offset).to(dtype)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    if ndisp > 256:
        raise ValueError("the CUDA cost kernel takes ndisp <= 256")
    lib = _lib()
    smem = lib.svt_cost_volume_smem(ndisp, block_size)
    optin = torch.cuda.get_device_properties(left.device).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"the CUDA cost kernel at block_size {block_size}, ndisp {ndisp} needs {smem} bytes of "
                         f"shared memory a block; {left.device} has {optin}")
    left, right = left.contiguous(), right.contiguous()
    out = torch.empty((B, H, W - x_offset, ndisp), dtype=dtype, device=left.device)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = lib.svt_cost_volume(left.data_ptr(), right.data_ptr(), out.data_ptr(), B, H, W, ndisp, mindisp,
                              block_size, ftzero, x_offset, out.element_size(), stream)
    _build.check(lib, err, "svt_cost_volume")
    cost_volume.launches += 1
    return out


cost_volume.launches = 0
