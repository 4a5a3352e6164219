"""Banded SGBM core of the hierarchical matcher: wrappers over ``csrc/banded.cu``.

Replaces ``stereo_vision_tpu/stereo/banded_pallas.py::banded_stats_pack``
and the kernel bodies it chains:

- ``_pix_kernel`` + ``_aligned_box_kernel(_srows)`` -> :func:`banded_cost`
- ``_vert_kernel`` (without and with diagonals)     -> :func:`banded_vertical`
- ``_horiz_kernel``                                 -> :func:`banded_horizontal`
- ``_wta_kernel`` (6-stat and 4-stat ``sub``)       -> :func:`banded_wta`
- ``_wta_fused_kernel`` (band 16)                   -> :func:`banded_wta_fused`

and the hier image pyramid's ``downsample_box_pack`` (``_downsample_kernel``)
-> :func:`downsample_box`.

Each wrapper launches its kernel for CUDA tensors and runs its plain form
(built from :mod:`.banded`, the port of the JAX scan reference) for CPU
tensors; ``launches`` on each wrapper counts kernel launches. The layout
is the port's own: banded volumes are (P, H, Wv, K) with the frames on the
CUDA grid. The kernels take every band K with K % 4 == 0 and 4 <= K <= 64
(:func:`check_band`); the sources are ``csrc/banded.cu`` and, for the
8-path vertical, ``csrc/banded_diag.cu`` (int16) and ``csrc/banded_diag32.cu``
(int32).

Integer ranges: a windowed cost is at most ``cost_bound`` (block_size^2 *
(2*ftzero + 63)); a banded SGM update keeps c <= L <= c + P2, so one
direction volume is at most cost_bound + P2, and an 8-path vertical set
(the sum of three carries) 3 * (cost_bound + P2). The kernels store costs
and volumes as int16 where that bound fits and as int32 otherwise
(:func:`.sgm_cuda.storage_dtype`), one type for a whole core; the WTA sums
the volumes in int32.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.stereo.banded import banded_cost_volume, horizontal_plain, vertical_plain
from stereo_vision_tpu_torch.stereo.cost_cuda import cost_dtype
from stereo_vision_tpu_torch.stereo.sgbm import subpixel_disp16
from stereo_vision_tpu_torch.stereo.sgm_cuda import storage_dtype, wta_scan

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The 8-path vertical's entry points: one source a storage type
# (banded_diag.cu: int16, banded_diag32.cu: int32).
_DIAG_SIGNATURES = {
    # C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, stream
    "svt_banded_vertical_diag": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # P, Wv, K, device -> bytes of scratch the diagonal scan needs (-1: refused)
    "svt_banded_vertical_diag_scratch_bytes": ([_I] * 4, _LL),
}
# Per source: entry point -> (argument types, result type). `bytes` is the
# storage type's width (2: int16, 4: int32).
_SIGNATURES = {
    "banded": {
        # left, right, s, out, P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, bytes, stream
        "svt_banded_cost": ([_P] * 4 + [_I] * 11 + [_P], _I),
        # K, ndisp, bs -> bytes of shared memory a block of the cost kernel takes
        "svt_banded_cost_smem": ([_I] * 3, _LL),
        # C, s, dn, up, P, H, Wv, K, G, P1, P2, bytes, stream
        "svt_banded_vertical": ([_P] * 4 + [_I] * 8 + [_P], _I),
        # C, s, out, P, H, Wv, K, G, P1, P2, reverse, bytes, stream
        "svt_banded_horizontal": ([_P] * 3 + [_I] * 9 + [_P], _I),
        # v0..v3, nvol, minS, best, m2, m3, m4, uok, npix, K, uniq, sub, bytes, stream
        "svt_banded_wta": ([_P] * 4 + [_I] + [_P] * 6 + [_I] * 5 + [_P], _I),
        # v0..v3, nvol, s, pack, du, npix, K, uniq, bytes, stream
        "svt_banded_wta_fused": ([_P] * 4 + [_I] + [_P] * 3 + [_I] * 4 + [_P], _I),
        # in, out, P, H, W, fy, fx, stream
        "svt_downsample_box": ([_P] * 2 + [_I] * 5 + [_P], _I),
    },
    "banded_diag": _DIAG_SIGNATURES,
    "banded_diag32": _DIAG_SIGNATURES,
}


def _lib(source: str = "banded") -> ctypes.CDLL:
    lib = _build.library(source)
    for name, (argtypes, restype) in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def check_band(K: int) -> None:
    """The bands the CUDA kernels take: K % 4 == 0 (a pixel's lanes then
    start on a 4-lane word) and 4 <= K <= 64 (the vertical and WTA kernels
    keep a pixel's lanes in one thread's registers)."""
    if K % 4 or not 4 <= K <= 64:
        raise ValueError(f"the CUDA banded kernels take a band K with K % 4 == 0 and 4 <= K <= 64, got {K}")


def _check_shift(s: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """s: (P, H, Wv) int32 on C's device; returned contiguous."""
    if s.shape != C.shape[:3] or s.dtype != torch.int32 or s.device != C.device:
        raise ValueError(f"expected an int32 shift map of shape {tuple(C.shape[:3])}, got {tuple(s.shape)} {s.dtype}")
    return s.contiguous()


def _check_volume(C: torch.Tensor, P2: int, cost_bound: int, summed: int = 1) -> torch.Tensor:
    """C as the CUDA scans store it: int32 where it is int32 or where
    ``summed`` carries a stored value (3 for the 8-path vertical sets) need
    it (:func:`.sgm_cuda.storage_dtype`), else int16; CPU tensors as given."""
    if C.dim() != 4:
        raise ValueError(f"expected a (P, H, Wv, K) banded volume, got {tuple(C.shape)}")
    if _on_cuda(C):
        check_band(C.shape[-1])
        if C.dtype not in (torch.int16, torch.int32) or not C.is_contiguous() or C.data_ptr() % 16:
            raise TypeError("the CUDA banded scans take a contiguous, 16-byte aligned int16 or int32 volume")
        if C.dtype == torch.int16 and storage_dtype(cost_bound, P2, summed) == torch.int32:
            return C.to(torch.int32)
    return C


# ------------------------------------------------------------------- cost


def banded_cost_plain(left, right, s, *, band: int, G: int, ndisp: int, ftzero: int, block_size: int,
                      min_x: int, stride: int = 1, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain form of :func:`banded_cost` (contiguous)."""
    C = banded_cost_volume(left, right, s, band=band, G=G, ndisp=ndisp, ftzero=ftzero, block_size=block_size,
                           stride=stride)
    return C[:, :, min_x:].to(cost_dtype(block_size, ftzero, dtype)).contiguous()


def banded_cost(left, right, s, *, band: int, G: int, ndisp: int, ftzero: int = 15, block_size: int = 5,
                min_x: int = 0, stride: int = 1, dtype: torch.dtype | None = None) -> torch.Tensor:
    """(P, H, W) int32 image pairs and shift map -> (P, H, W - min_x, band)
    windowed banded cost: BT pixel cost at disparity s(q) + stride*j for
    every window pixel q, aligned into the centre's band (rows, then
    columns), for columns x >= min_x. ``ndisp`` is the level's full
    disparity range (the disparity index is clamped to it); ``stride > 1``
    is the coarse level's strided search (at s == 0). ``dtype``: int16 or
    int32, by default int16 where a window's cost bound fits it."""
    if not (left.shape == right.shape == s.shape) or left.dim() != 3:
        raise ValueError(f"expected (P, H, W) images and shift map, got {tuple(left.shape)}, "
                         f"{tuple(right.shape)}, {tuple(s.shape)}")
    if left.dtype != torch.int32 or right.dtype != torch.int32 or s.dtype != torch.int32:
        raise TypeError("banded_cost takes int32 images and an int32 shift map")
    if not left.device == right.device == s.device:
        raise ValueError("images and shift map lie on different devices")
    P, H, W = left.shape
    if not 0 <= min_x < W or ndisp < 1 or band < 1 or G < 0 or stride < 1:
        raise ValueError(f"bad min_x={min_x} / ndisp={ndisp} / band={band} / G={G} / stride={stride}")
    if block_size % 2 != 1 or block_size < 1:
        raise ValueError(f"block_size must be odd and >= 1, got {block_size}")
    dtype = cost_dtype(block_size, ftzero, dtype)
    kw = dict(band=band, G=G, ndisp=ndisp, ftzero=ftzero, block_size=block_size, min_x=min_x, stride=stride)
    if not _on_cuda(left):
        return banded_cost_plain(left, right, s, **kw, dtype=dtype)
    check_band(band)
    lib = _lib()
    smem = lib.svt_banded_cost_smem(band, ndisp, block_size)
    optin = torch.cuda.get_device_properties(left.device).shared_memory_per_block_optin
    if smem > optin:
        raise ValueError(f"the CUDA banded cost kernel at band {band}, ndisp {ndisp}, block_size {block_size} "
                         f"needs {smem} bytes of shared memory a block; {left.device} has {optin}")
    left, right, s = left.contiguous(), right.contiguous(), s.contiguous()
    out = torch.empty((P, H, W - min_x, band), dtype=dtype, device=left.device)
    err = lib.svt_banded_cost(left.data_ptr(), right.data_ptr(), s.data_ptr(), out.data_ptr(), P, H, W, band, G,
                              ndisp, block_size, ftzero, min_x, stride, out.element_size(), _stream(left))
    _build.check(lib, err, "svt_banded_cost")
    banded_cost.launches += 1
    return out


# ------------------------------------------------------------------ scans


def banded_vertical(C, s, G: int, P1: int, P2: int, *, cost_bound: int, with_diagonals: bool = False):
    """(P, H, Wv, K) banded cost + (P, H, Wv) shift map -> (down, up)
    direction volumes (int16 or int32 on CUDA, as :func:`_check_volume`
    stores them; int32 plain). With diagonals (8 paths) each volume is the
    sum of its set of three: vertical, (1,1) and (-1,1) carries (the up set
    scans the y-flipped volume with the same column shifts). ``launches``
    counts both kernels, ``diagonal_launches`` the diagonal one."""
    C = _check_volume(C, P2, cost_bound, 3 if with_diagonals else 1)
    if P1 < 0 or P2 < 0:
        raise ValueError("P1 and P2 must be >= 0")
    if not _on_cuda(C):
        return vertical_plain(C, s, G, P1, P2, with_diagonals)
    s = _check_shift(s, C)
    P, H, Wv, K = C.shape
    dn, up = torch.empty_like(C), torch.empty_like(C)
    if with_diagonals:
        # The kernel keeps its carry rows in shared memory where they fit and
        # says how much device scratch it needs where they do not.
        lib = _lib("banded_diag" if C.dtype == torch.int16 else "banded_diag32")
        nbytes = lib.svt_banded_vertical_diag_scratch_bytes(P, Wv, K, C.device.index)
        if nbytes < 0:
            raise ValueError(f"the CUDA diagonal scan does not take {Wv} columns on {C.device}")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=C.device) if nbytes else None
        err = lib.svt_banded_vertical_diag(C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr(),
                                           None if scratch is None else scratch.data_ptr(), P, H, Wv, K, G, P1, P2,
                                           _stream(C))
        _build.check(lib, err, "svt_banded_vertical_diag")
        banded_vertical.diagonal_launches += 1
    else:
        lib = _lib()
        err = lib.svt_banded_vertical(C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr(), P, H, Wv, K, G, P1,
                                      P2, C.element_size(), _stream(C))
        _build.check(lib, err, "svt_banded_vertical")
    banded_vertical.launches += 1
    return dn, up


def banded_horizontal(C, s, G: int, P1: int, P2: int, *, cost_bound: int, reverse: bool = False):
    """(P, H, Wv, K) banded cost + shift map -> the L->R (``reverse``:
    R->L) direction volume (int16 or int32 on CUDA, as :func:`_check_volume`
    stores it; int32 plain)."""
    C = _check_volume(C, P2, cost_bound)
    if P1 < 0 or P2 < 0:
        raise ValueError("P1 and P2 must be >= 0")
    if not _on_cuda(C):
        return horizontal_plain(C, s, G, P1, P2, reverse)
    s = _check_shift(s, C)
    P, H, Wv, K = C.shape
    out = torch.empty_like(C)
    lib = _lib()
    err = lib.svt_banded_horizontal(C.data_ptr(), s.data_ptr(), out.data_ptr(), P, H, Wv, K, G, P1, P2,
                                    int(reverse), C.element_size(), _stream(C))
    _build.check(lib, err, "svt_banded_horizontal")
    banded_horizontal.launches += 1
    return out


# -------------------------------------------------------------------- WTA


def banded_wta_plain(volumes, uniqueness_ratio: int, sub: bool = False):
    """Plain form of :func:`banded_wta`."""
    S = volumes[0].to(torch.int32)
    for v in volumes[1:]:
        S = S + v.to(torch.int32)
    K = S.shape[-1]
    minS, best, sm, s0, sp, uok = wta_scan(S, K, uniqueness_ratio)
    if sub:
        return minS, best, subpixel_disp16(best, sm, s0, sp, K), uok
    return minS, best, sm, s0, sp, uok


def _check_wta_volumes(volumes: list, what: str) -> None:
    """2-4 (P, H, Wv, K >= 3) volumes of one shape on one device; on CUDA,
    contiguous and aligned, of one type (int16 or int32), with fewer than
    2^31 pixels."""
    v0 = volumes[0]
    if not 2 <= len(volumes) <= 4 or any(v.shape != v0.shape or v.device != v0.device for v in volumes):
        raise ValueError(f"{what} takes 2-4 direction volumes of one shape on one device")
    if v0.dim() != 4 or v0.shape[-1] < 3:
        raise ValueError(f"expected (P, H, Wv, K>=3) volumes, got {tuple(v0.shape)}")
    if _on_cuda(v0):
        check_band(v0.shape[-1])
        if v0.dtype not in (torch.int16, torch.int32) or any(
                v.dtype != v0.dtype or not v.is_contiguous() or v.data_ptr() % 16 for v in volumes):
            raise TypeError(f"the CUDA kernel of {what} takes contiguous, 16-byte aligned volumes of one type, "
                            "int16 or int32")
        if v0.shape[:3].numel() >= 1 << 31:
            raise ValueError(f"the CUDA kernel of {what} takes fewer than 2^31 pixels a call")


def banded_wta(volumes, uniqueness_ratio: int, sub: bool = False):
    """Sum 2-4 (P, H, Wv, K) direction volumes and reduce over the K lanes:
    (minS, best_k, sm, s0, sp, unique_ok), or with ``sub`` (minS, best_k,
    sub16, unique_ok) where sub16 is the subpixel parabola in lane units
    (``ndisp = K``). Maps are int32, ``unique_ok`` bool; ties go to the
    smallest k, uniqueness is band-local (|k - best| > 1)."""
    volumes = list(volumes)
    _check_wta_volumes(volumes, "banded_wta")
    v0 = volumes[0]
    if not _on_cuda(v0):
        return banded_wta_plain(volumes, uniqueness_ratio, sub)
    P, H, Wv, K = v0.shape
    maps = [torch.empty((P, H, Wv), dtype=torch.int32, device=v0.device) for _ in range(3 if sub else 5)]
    uok = torch.empty((P, H, Wv), dtype=torch.bool, device=v0.device)
    ptrs = [v.data_ptr() for v in volumes] + [None] * (4 - len(volumes))
    mptrs = [m.data_ptr() for m in maps] + [None] * (5 - len(maps))
    lib = _lib()
    err = lib.svt_banded_wta(*ptrs, len(volumes), *mptrs, uok.data_ptr(), P * H * Wv, K, uniqueness_ratio,
                             int(sub), v0.element_size(), _stream(v0))
    _build.check(lib, err, "svt_banded_wta")
    banded_wta.launches += 1
    return (*maps, uok)


FUSED_BAND = 16  # the fused WTA's one band, as the TPU kernel's


def banded_wta_fused_plain(volumes, s, uniqueness_ratio: int):
    """Plain form of :func:`banded_wta_fused`, in int32."""
    minS, best, sub16, uok = banded_wta_plain(volumes, uniqueness_ratio, sub=True)
    if minS.numel() and int(minS.max()) >= 1 << 20:
        raise ValueError("minS * 2048 does not fit the int32 pack")
    s = s.to(torch.int32)
    return minS * 2048 + (best + s), (sub16 + 16 * s) + uok.to(torch.int32) * 32768


def banded_wta_fused(volumes, s, uniqueness_ratio: int, *, ndisp: int, volume_bound: int | None = None):
    """The band-16 WTA fused with the LR check's inputs: 2-4 (P, H, Wv, 16)
    direction volumes and the (P, H, Wv) int32 shift map on the same
    columns -> two (P, H, Wv) int32 maps, ``pack = minS * 2048 + (best +
    s)`` (the packed LR check's input) and ``du = d16 + 32768 * unique_ok``
    with ``d16 = sub16 + 16 * s`` the absolute disparity x16 (the reductions
    of :func:`banded_wta` with ``sub``).

    ``ndisp`` is the level's disparity range, and the shift map lies in
    [0, ndisp - 16], as every map :func:`.hier.shift_map` builds. The fields
    cannot collide when 16 * ndisp < 32768: best + s < ndisp fits the pack's
    11 bits and d16 < 16 * ndisp stays below the uniqueness bit (the JAX
    kernel relies on its presets instead). ``volume_bound`` bounds one
    volume's values (int16 volumes: 2^15 - 1 by their type; int32 volumes
    need it): minS * 2048 stays inside int32 when the volumes' sum is
    bounded below 2^20."""
    volumes = list(volumes)
    _check_wta_volumes(volumes, "banded_wta_fused")
    v0 = volumes[0]
    P, H, Wv, K = v0.shape
    if K != FUSED_BAND:
        raise ValueError(f"the fused WTA takes band {FUSED_BAND}, got {K}")
    if not K <= ndisp or 16 * ndisp >= 1 << 15:
        raise ValueError(f"ndisp {ndisp} leaves [{K}, 2047]: the pack and d16 fields would collide")
    if s.shape != v0.shape[:3] or s.dtype != torch.int32 or s.device != v0.device:
        raise ValueError(f"expected an int32 shift map of shape {(P, H, Wv)}, got {tuple(s.shape)} {s.dtype}")
    if not _on_cuda(v0):
        return banded_wta_fused_plain(volumes, s, uniqueness_ratio)
    if volume_bound is None:
        if v0.dtype != torch.int16:
            raise ValueError("the fused WTA needs volume_bound for int32 volumes")
        volume_bound = (1 << 15) - 1
    if len(volumes) * volume_bound >= 1 << 20:
        raise ValueError(f"{len(volumes)} volumes bounded by {volume_bound}: minS * 2048 does not fit the int32 pack")
    s = s.contiguous()
    pack, du = (torch.empty((P, H, Wv), dtype=torch.int32, device=v0.device) for _ in range(2))
    ptrs = [v.data_ptr() for v in volumes] + [None] * (4 - len(volumes))
    lib = _lib()
    err = lib.svt_banded_wta_fused(*ptrs, len(volumes), s.data_ptr(), pack.data_ptr(), du.data_ptr(), P * H * Wv,
                                   K, uniqueness_ratio, v0.element_size(), _stream(v0))
    _build.check(lib, err, "svt_banded_wta_fused")
    banded_wta_fused.launches += 1
    return pack, du


def banded_stats_pack(left, right, s, params, band: int, G: int, min_x: int, stride: int = 1, sub: bool = False,
                      fused: bool = False):
    """Banded core of P frames: cost + aggregation over ``params.num_paths``
    (2: vertical pair, 3: + L->R, 4: + R->L, 8: + diagonals in the vertical
    sets) + WTA on columns x >= min_x. (P, H, W) int32 images and shift map
    -> the maps of :func:`banded_wta`, shape (P, H, W - min_x), or with
    ``fused`` the (pack, du) maps of :func:`banded_wta_fused`. ``stride``:
    lane k is disparity s + stride * k (the coarse level's strided search)."""
    if params.num_paths not in (2, 3, 4, 8):
        raise ValueError(f"num_paths must be 2, 3, 4 or 8, got {params.num_paths}")
    P1, P2, bound = params.P1, params.P2, params.cost_bound
    summed = 3 if params.num_paths == 8 else 1
    C = banded_cost(left, right, s, band=band, G=G, ndisp=params.num_disparities, ftzero=params.ftzero,
                    block_size=params.block_size, min_x=min_x, stride=stride,
                    dtype=storage_dtype(bound, P2, summed))
    sv = s[:, :, min_x:].contiguous()
    vols = list(banded_vertical(C, sv, G, P1, P2, cost_bound=bound, with_diagonals=params.num_paths == 8))
    if params.num_paths >= 3:
        vols.append(banded_horizontal(C, sv, G, P1, P2, cost_bound=bound))
    if params.num_paths in (4, 8):
        vols.append(banded_horizontal(C, sv, G, P1, P2, cost_bound=bound, reverse=True))
    if fused:
        return banded_wta_fused(vols, sv, params.uniqueness_ratio, ndisp=params.num_disparities,
                                volume_bound=summed * (bound + P2))
    return banded_wta(vols, params.uniqueness_ratio, sub)


# ------------------------------------------------------------- downsample


def downsample_box_plain(img: torch.Tensor, f: int, fx: int | None = None) -> torch.Tensor:
    """Plain form of :func:`downsample_box`: the sum is an exact integer and
    the division float32, as in the reference."""
    fy, fx = f, f if fx is None else fx
    H, W = img.shape[-2:]
    Hc, Wc = H // fy, W // fx
    x = img[..., : Hc * fy, : Wc * fx].to(torch.int32)
    u = x.reshape(*x.shape[:-2], Hc, fy, Wc, fx).sum(dim=(-3, -1), dtype=torch.int32)
    return torch.round(u.to(torch.float32) / (fy * fx)).to(torch.int32)


def downsample_box(img: torch.Tensor, f: int, fx: int | None = None) -> torch.Tensor:
    """(P, H, W) int32 frames -> (P, H // f, W // fx) int32 box mean,
    round(sum / (f * fx)) half to even; trailing rows and columns that
    fill no block are dropped."""
    fy, fx = f, f if fx is None else fx
    if img.dim() != 3 or img.dtype != torch.int32:
        raise ValueError(f"expected (P, H, W) int32 frames, got {tuple(img.shape)} {img.dtype}")
    if fy < 1 or fx < 1:
        raise ValueError(f"bad factors {fy} x {fx}")
    if not _on_cuda(img):
        return downsample_box_plain(img, fy, fx)
    P, H, W = img.shape
    img = img.contiguous()
    out = torch.empty((P, H // fy, W // fx), dtype=torch.int32, device=img.device)
    lib = _lib()
    err = lib.svt_downsample_box(img.data_ptr(), out.data_ptr(), P, H, W, fy, fx, _stream(img))
    _build.check(lib, err, "svt_downsample_box")
    downsample_box.launches += 1
    return out


banded_cost.launches = 0
banded_vertical.launches = 0
banded_vertical.diagonal_launches = 0
banded_horizontal.launches = 0
banded_wta.launches = 0
banded_wta_fused.launches = 0
downsample_box.launches = 0
