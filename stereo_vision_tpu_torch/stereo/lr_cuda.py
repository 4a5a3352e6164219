"""Left-right consistency checks of both SGBM paths: wrappers over ``csrc/lr.cu``.

Replace the two forms of ``stereo_vision_tpu/stereo/lr_pallas.py``'s kernel
body ``_lr_kernel``:

- ``lr_fail_pallas_packed`` (the hier assembly's LR check) -> :func:`lr_fail_packed`
- ``lr_fail_pallas`` (the exact path's, any min_disparity)  -> :func:`lr_fail`

Each wrapper launches its kernel for CUDA tensors and runs its plain form
for CPU tensors; ``launches`` on each counts kernel launches. The plain
form of both is the shift-chain
:func:`stereo_vision_tpu_torch.stereo.sgbm.lr_fail` (on the unpacked maps),
which the JAX package holds bit-identical to the Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.device import stream_handle
from stereo_vision_tpu_torch.stereo.sgbm import lr_fail as lr_fail_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pack, d16, fail, rows, W, Wv, ndisp, max_diff, stream
    "svt_lr_fail_packed": [_P] * 3 + [_I] * 5 + [_P],
    # minS, best, disp, fail, rows, W, Wv, min_x, ndisp, mindisp, max_diff, stream
    "svt_lr_fail": [_P] * 4 + [_I] * 7 + [_P],
}


_LIBS: list[ctypes.CDLL] = []  # the library, signatures set


def _lib() -> ctypes.CDLL:
    if not _LIBS:
        lib = _build.library("lr")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _LIBS.append(lib)
    return _LIBS[0]


def lr_fail_packed_plain(pack, d16, *, W: int, ndisp: int, max_diff: int) -> torch.Tensor:
    """Plain form of :func:`lr_fail_packed`."""
    return lr_fail_plain(pack >> 11, pack & 2047, d16.to(torch.float32) / 16.0, W=W, min_x=ndisp, ndisp=ndisp,
                         mindisp=0, max_diff=max_diff)


def lr_fail_packed(pack, d16, *, W: int, ndisp: int, max_diff: int) -> torch.Tensor:
    """cv2 LR-consistency failure mask (True = invalidate) of (P, H, Wv)
    maps on the valid columns x >= ndisp of W-wide frames.

    ``pack`` is cost * 2048 + winner (int32; winner = the absolute WTA
    disparity in [0, ndisp)), ``d16`` the 16x fixed-point disparity
    (int32); ``ndisp`` is the full disparity range, minimum disparity 0."""
    if pack.dim() != 3 or pack.shape != d16.shape or pack.device != d16.device:
        raise ValueError(f"expected two (P, H, Wv) maps on one device, got {tuple(pack.shape)}, {tuple(d16.shape)}")
    if pack.dtype != torch.int32 or d16.dtype != torch.int32:
        raise TypeError("lr_fail_packed takes int32 pack and d16 maps")
    P, H, Wv = pack.shape
    if not 0 < ndisp < 1 << 11 or Wv != W - ndisp:
        raise ValueError(f"need 0 < ndisp < 2048 and Wv == W - ndisp, got ndisp={ndisp}, W={W}, Wv={Wv}")
    kw = dict(W=W, ndisp=ndisp, max_diff=max_diff)
    if pack.device.type == "cpu":
        return lr_fail_packed_plain(pack, d16, **kw)
    if pack.device.type != "cuda":
        raise ValueError(f"unsupported device {pack.device}")
    # The kernel reads 16-byte words: contiguous maps on 16-byte addresses.
    pack, d16 = (m.contiguous() for m in (pack, d16))
    pack, d16 = (m if m.data_ptr() % 16 == 0 else m.clone() for m in (pack, d16))
    fail = torch.empty((P, H, Wv), dtype=torch.bool, device=pack.device)
    lib = _lib()
    err = lib.svt_lr_fail_packed(pack.data_ptr(), d16.data_ptr(), fail.data_ptr(), P * H, W, Wv, ndisp, max_diff,
                                 stream_handle(pack))
    _build.check(lib, err, "svt_lr_fail_packed")
    lr_fail_packed.launches += 1
    return fail


lr_fail_packed.launches = 0


def lr_fail(minS, best, disp, *, W: int, min_x: int, ndisp: int, mindisp: int, max_diff: int) -> torch.Tensor:
    """cv2 LR-consistency failure mask (True = invalidate) of (B, H, Wv)
    maps on the columns x >= min_x of W-wide frames: the signature and
    semantics of :func:`.sgbm.lr_fail`, its plain form. ``minS`` and ``best``
    are int32 (``best`` without ``mindisp``), ``disp`` the float32 subpixel
    disparity (with ``mindisp``); ``ndisp`` is the full range, and
    ``min_disparity >= 0``."""
    if minS.dim() != 3 or not (minS.shape == best.shape == disp.shape):
        raise ValueError(f"expected three (B, H, Wv) maps, got {tuple(minS.shape)}, {tuple(best.shape)}, "
                         f"{tuple(disp.shape)}")
    if not minS.device == best.device == disp.device:
        raise ValueError("the LR check's maps lie on different devices")
    B, H, Wv = minS.shape
    if ndisp + abs(mindisp) >= 1 << 11:
        raise ValueError("disparity range exceeds the 11-bit pack field")
    if mindisp < 0:
        raise ValueError("the LR check assumes min_disparity >= 0")
    if ndisp < 1 or min_x < 0 or min_x + Wv > W:
        raise ValueError(f"need ndisp >= 1 and 0 <= min_x <= W - Wv, got ndisp={ndisp}, min_x={min_x}, W={W}, "
                         f"Wv={Wv}")
    kw = dict(W=W, min_x=min_x, ndisp=ndisp, mindisp=mindisp, max_diff=max_diff)
    if minS.device.type == "cpu":
        return lr_fail_plain(minS, best, disp, **kw)
    if minS.device.type != "cuda":
        raise ValueError(f"unsupported device {minS.device}")
    if minS.dtype != torch.int32 or best.dtype != torch.int32 or disp.dtype != torch.float32:
        raise TypeError("the CUDA LR check takes int32 minS and best and a float32 disparity")
    # The kernel reads 16-byte words: contiguous maps on 16-byte addresses.
    minS, best, disp = (m.contiguous() for m in (minS, best, disp))
    minS, best, disp = (m if m.data_ptr() % 16 == 0 else m.clone() for m in (minS, best, disp))
    fail = torch.empty((B, H, Wv), dtype=torch.bool, device=minS.device)
    lib = _lib()
    err = lib.svt_lr_fail(minS.data_ptr(), best.data_ptr(), disp.data_ptr(), fail.data_ptr(), B * H, W, Wv, min_x,
                          ndisp, mindisp, max_diff, stream_handle(minS))
    _build.check(lib, err, "svt_lr_fail")
    lr_fail.launches += 1
    return fail


lr_fail.launches = 0
