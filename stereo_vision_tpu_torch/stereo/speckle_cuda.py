"""Disparity speckle filter: wrapper over ``csrc/speckle.cu``.

Replaces ``stereo_vision_tpu/stereo/speckle_pallas.py::speckle_filter_pallas``
(kernel body ``_speckle_kernel``). :func:`speckle_filter` launches the
kernel for CUDA tensors and runs its plain form,
:func:`stereo_vision_tpu_torch.stereo.postprocess.speckle_filter`, for CPU
tensors; the two are equal bit for bit for any ``max_diameter``.
``launches`` counts wrapper calls that launched the kernel sequence
(3R + 2 device launches each).
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.stereo.postprocess import speckle_filter as speckle_filter_plain, speckle_rounds

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # disp, out, ws32, ws8, P, H, W, S, R, max_diff, invalid, stream
    "svt_speckle_filter": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = _build.library("speckle")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def speckle_filter(
    disp: torch.Tensor,
    max_diff: float = 1.0,
    max_speckle_size: int = 100,
    invalid_value: float = -1.0,
    max_diameter: int | None = None,
) -> torch.Tensor:
    """Remove small disparity blobs from (..., H, W) float32 maps; the
    semantics of :func:`.postprocess.speckle_filter`, whose docstring has
    them (``max_diameter`` caps the rounds, None is exact cv2)."""
    if disp.dim() < 2:
        raise ValueError(f"expected (..., H, W) maps, got {tuple(disp.shape)}")
    kw = dict(max_diff=max_diff, max_speckle_size=max_speckle_size, invalid_value=invalid_value,
              max_diameter=max_diameter)
    if disp.device.type == "cpu":
        return speckle_filter_plain(disp, **kw)
    if disp.device.type != "cuda":
        raise ValueError(f"unsupported device {disp.device}")
    S = int(max_speckle_size)
    if S <= 0:
        return disp
    if disp.dtype != torch.float32:
        raise TypeError(f"the CUDA speckle filter takes float32 maps, got {disp.dtype}")
    H, W = disp.shape[-2:]
    frames = disp.reshape(-1, H, W).contiguous()
    P = frames.shape[0]
    n = P * H * W
    if n >= 1 << 31:
        raise ValueError("the CUDA speckle filter takes fewer than 2^31 pixels a call")
    out = torch.empty_like(frames)
    ws32 = torch.empty(5 * n, dtype=torch.int32, device=disp.device)
    ws8 = torch.empty(4 * n, dtype=torch.uint8, device=disp.device)
    lib = _lib()
    err = lib.svt_speckle_filter(frames.data_ptr(), out.data_ptr(), ws32.data_ptr(), ws8.data_ptr(), P, H, W, S,
                                 speckle_rounds(S, max_diameter), float(max_diff), float(invalid_value),
                                 torch.cuda.current_stream(disp.device).cuda_stream)
    _build.check(lib, err, "svt_speckle_filter")
    speckle_filter.launches += 1
    return out.reshape(disp.shape)


speckle_filter.launches = 0
