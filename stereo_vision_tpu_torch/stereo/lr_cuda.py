"""Left-right consistency check of the hier assembly: wrapper over ``csrc/lr.cu``.

Replaces ``stereo_vision_tpu/stereo/lr_pallas.py::lr_fail_pallas_packed``
(kernel body ``_lr_kernel``), the LR check the JAX package runs on the TPU
for the hierarchical matcher's levels. :func:`lr_fail_packed` launches the
kernel for CUDA tensors and runs its plain form for CPU tensors; its
``launches`` counts kernel launches. The plain form is the shift-chain
:func:`stereo_vision_tpu_torch.stereo.sgbm.lr_fail` on the unpacked maps,
which the JAX package holds bit-identical to the Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.stereo.sgbm import lr_fail

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pack, d16, fail, rows, W, Wv, ndisp, max_diff, stream
    "svt_lr_fail_packed": [_P] * 3 + [_I] * 5 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.library("lr")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def lr_fail_packed_plain(pack, d16, *, W: int, ndisp: int, max_diff: int) -> torch.Tensor:
    """Plain form of :func:`lr_fail_packed`."""
    return lr_fail(pack >> 11, pack & 2047, d16.to(torch.float32) / 16.0, W=W, min_x=ndisp, ndisp=ndisp, mindisp=0,
                   max_diff=max_diff)


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
    pack, d16 = pack.contiguous(), d16.contiguous()
    fail = torch.empty((P, H, Wv), dtype=torch.bool, device=pack.device)
    lib = _lib()
    err = lib.svt_lr_fail_packed(pack.data_ptr(), d16.data_ptr(), fail.data_ptr(), P * H, W, Wv, ndisp, max_diff,
                                 torch.cuda.current_stream(pack.device).cuda_stream)
    _build.check(lib, err, "svt_lr_fail_packed")
    lr_fail_packed.launches += 1
    return fail


lr_fail_packed.launches = 0
