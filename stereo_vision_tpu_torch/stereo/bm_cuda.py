"""Block matching's fused kernel: wrapper over ``csrc/bm.cu``.

Replaces ``stereo_vision_tpu/stereo/bm_pallas.py::bm_stats_pallas`` (kernel
body ``_bm_kernel``) with :func:`bm_disparity`: prefiltered images in, the
window-centre disparity map out, the SAD cost volume never in device
memory. It launches the kernel for CUDA tensors (``launches`` counts them)
and runs its plain form, :func:`.bm.valid_disparity_plain` (the JAX XLA
path's cost volume, box sums and WTA), for CPU tensors. Unlike the Pallas
kernel it takes any ``min_disparity``, so no setting leaves the card.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.device import device_index, stream_handle
from stereo_vision_tpu_torch.stereo.bm import valid_disparity_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # lp, rp, out, B, H, W, D, mindisp, bs, cap, uniq, tex_thr, scratch, stream
    "svt_bm_disparity": ([_P] * 3 + [_I] * 9 + [_P, _P], _I),
    # B, H, W, D, mindisp, bs, cap, device -> bytes of device scratch the call needs (-1: refused)
    "svt_bm_scratch_bytes": ([_I] * 8, ctypes.c_longlong),
    # D, mindisp, bs, cap, device -> the form the call takes (an index of FORMS; -1: refused)
    "svt_bm_form": ([_I] * 5, _I),
}
# The kernel's forms: the row form with 16-bit packed window sums (where
# bs^2 * 2 cap < 2^16 and cap <= 127), the row form on int32 sums, and the
# wide form (above 1024 disparities, or where no row layout fits a block).
FORMS = ("packed16", "int32", "wide")


def _lib() -> ctypes.CDLL:
    lib = _build.library("bm")
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def kernel_form(*, ndisp: int, mindisp: int, block_size: int, cap: int, device: int | None = None) -> str:
    """The form of the CUDA kernel a call with these settings takes on CUDA
    device ``device`` (the current one by default): one of :data:`FORMS`."""
    index = torch.cuda.current_device() if device is None else device
    form = _lib().svt_bm_form(ndisp, mindisp, block_size, cap, index)
    if form < 0:
        raise RuntimeError(f"svt_bm_form: device query failed on cuda:{index}")
    return FORMS[form]


def bm_disparity(lp, rp, *, ndisp: int, mindisp: int, block_size: int, cap: int, uniq: int,
                 tex_thr: int) -> torch.Tensor:
    """(B, H, W) int32 prefiltered left/right images -> (B, H-bs+1, W-bs+1)
    float32 disparity of the window centres: WTA over ``ndisp`` disparities
    from ``mindisp`` (ties to the smallest), cv2's subpixel parabola, and
    ``mindisp - 1`` where the texture sum of |lp - cap| is below ``tex_thr``,
    the uniqueness check (``uniq`` percent) fails or the window's disparity
    range leaves the frame. The images hold the prefilter's values,
    0..2 ``cap`` (as the reference's ``bm_stats_pallas`` takes them); the
    CUDA kernel's packed form stores them as bytes. It takes any ndisp (above
    1024 in its wide form); ``launches_by_form`` counts its launches by
    :data:`FORMS`."""
    if lp.dim() != 3 or lp.shape != rp.shape or lp.device != rp.device:
        raise ValueError(f"expected two (B, H, W) images on one device, got {tuple(lp.shape)}, {tuple(rp.shape)}")
    B, H, W = lp.shape
    if ndisp < 1 or block_size < 1 or H < block_size or W < block_size:
        raise ValueError(f"need ndisp >= 1 and a {block_size}-pixel block inside the {H}x{W} frame")
    if mindisp + ndisp - 1 < 0:
        raise ValueError(f"the largest disparity mindisp + ndisp - 1 = {mindisp + ndisp - 1} is negative")
    kw = dict(ndisp=ndisp, mindisp=mindisp, block_size=block_size, cap=cap, uniq=uniq, tex_thr=tex_thr)
    if lp.device.type == "cpu":
        return valid_disparity_plain(lp, rp, **kw)
    if lp.device.type != "cuda":
        raise ValueError(f"unsupported device {lp.device}")
    if lp.dtype != torch.int32 or rp.dtype != torch.int32 or not (lp.is_contiguous() and rp.is_contiguous()):
        raise TypeError("the CUDA BM kernel takes contiguous int32 images")
    out = torch.empty((B, H - block_size + 1, W - block_size + 1), dtype=torch.float32, device=lp.device)
    lib = _lib()
    dev = device_index(lp)
    form = kernel_form(ndisp=ndisp, mindisp=mindisp, block_size=block_size, cap=cap, device=dev)
    # Above 1024 disparities, or where no row layout fits a block's shared
    # memory, the kernel's wide form may keep its window sums in scratch.
    nbytes = lib.svt_bm_scratch_bytes(B, H, W, ndisp, mindisp, block_size, cap, dev)
    if nbytes < 0:
        raise RuntimeError(f"svt_bm_scratch_bytes: device query failed on {lp.device}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=lp.device) if nbytes else None
    err = lib.svt_bm_disparity(lp.data_ptr(), rp.data_ptr(), out.data_ptr(), B, H, W, ndisp, mindisp, block_size,
                               cap, uniq, tex_thr, None if scratch is None else scratch.data_ptr(),
                               stream_handle(lp))
    _build.check(lib, err, "svt_bm_disparity")
    bm_disparity.launches += 1
    bm_disparity.launches_by_form[form] += 1
    return out


bm_disparity.launches = 0
bm_disparity.launches_by_form = dict.fromkeys(FORMS, 0)
