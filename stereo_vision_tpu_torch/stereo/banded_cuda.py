"""Banded SGBM core of the hierarchical matcher: wrappers over ``csrc/banded.cu``.

Replaces ``stereo_vision_tpu/stereo/banded_pallas.py::banded_stats_pack``
and the kernel bodies it chains:

- ``_pix_kernel`` + ``_aligned_box_kernel(_srows)`` -> :func:`banded_cost`
- ``_vert_kernel`` (without and with diagonals)     -> :func:`banded_vertical`
- ``_horiz_kernel``                                 -> :func:`banded_horizontal`
- ``_wta_kernel`` (6-stat and 4-stat ``sub``)       -> :func:`banded_wta`
- ``_wta_fused_kernel`` (band 16)                   -> :func:`banded_wta_fused`

and the hier image pyramid's ``downsample_box_pack`` (``_downsample_kernel``)
-> :func:`downsample_pyramid` (both images, every level, one launch) and
:func:`downsample_box` (one level).

Each wrapper launches its kernel for CUDA tensors and runs its plain form
(built from :mod:`.banded`, the port of the JAX scan reference) for CPU
tensors; ``launches`` on each wrapper counts kernel launches. The layout
is the port's own: banded volumes are (P, H, Wv, K) with the frames on the
CUDA grid, a pixel's K lanes in K rounded up to 4 (:func:`lane_stride`).
The kernels take every band K >= 1 (:func:`check_band`). The sources:
``csrc/banded_cost.cu`` (the cost kernel at every band), ``csrc/banded.cu``
(the scans up to K = 64), ``csrc/downsample.cu`` (the pyramid), ``csrc/banded_wta.cu`` (the
WTA up to K = 64 and the fused WTA), ``csrc/banded_diag.cu``
(int16) and ``csrc/banded_diag32.cu`` (int32) for the 8-path vertical up to
K = 64, and ``csrc/banded_wide.cu`` (int16) and ``csrc/banded_wide32.cu``
(int32) for the scans and the WTA above K = 64, where a pixel's lanes
spread over a group of 32 threads (above 1024, a warp walks them with its
carry in device memory).

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
from stereo_vision_tpu_torch.device import device_index, stream_handle
from stereo_vision_tpu_torch.stereo.banded import banded_cost_volume, horizontal_plain, vertical_plain
from stereo_vision_tpu_torch.stereo.cost_cuda import cost_dtype
from stereo_vision_tpu_torch.stereo.sgbm import subpixel_disp16
from stereo_vision_tpu_torch.stereo.sgm_cuda import storage_dtype, wta_scan

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The 8-path vertical's entry points: one source a storage type
# (banded_diag.cu: int16, banded_diag32.cu: int32).
_DIAG_SIGNATURES = {
    # C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, form, CS, NT, S, stream
    "svt_banded_vertical_diag": ([_P] * 5 + [_I] * 11 + [_P], _I),
    # K, CS, NT, S -> clusters of the cluster form the current device holds at once
    "svt_banded_diag_clusters": ([_I] * 4, _I),
}
# The scans and the WTA above K = 64: one source a storage type
# (banded_wide.cu: int16, banded_wide32.cu: int32).
_WIDE_SIGNATURES = {
    # C, s, dn, up, scratch, P, H, Wv, K, G, P1, P2, diagonals, stream
    "svt_banded_wide_vertical": ([_P] * 5 + [_I] * 8 + [_P], _I),
    # P, Wv, K, device -> bytes of scratch the 8-path wide scan needs (-1: refused)
    "svt_banded_wide_diag_scratch_bytes": ([_I] * 4, _LL),
    # C, s, out, P, H, Wv, K, G, P1, P2, reverse, stream
    "svt_banded_wide_horizontal": ([_P] * 3 + [_I] * 8 + [_P], _I),
    # v0..v3, nvol, minS, best, m2, m3, m4, uok, npix, K, uniq, sub, stream
    "svt_banded_wide_wta": ([_P] * 4 + [_I] + [_P] * 6 + [_I] * 4 + [_P], _I),
}
WIDE_BAND = 64  # bands above this take the banded_wide sources
# Per source: entry point -> (argument types, result type). `bytes` is the
# storage type's width (2: int16, 4: int32).
_SIGNATURES = {
    "banded_cost": {
        # left, right, s, out, P, H, W, K, G, ndisp, bs, ftzero, min_x, stride, TX, bytes, scratch, stream
        "svt_banded_cost": ([_P] * 4 + [_I] * 12 + [_P, _P], _I),
        # K, ndisp, bs, Wo, device -> the cost kernel's tile width (0: no tile fits, -1: refused)
        "svt_banded_cost_tile": ([_I] * 5, _I),
        # P, H, Wo, K, ndisp, bs, device -> bytes of device scratch where no tile fits (-1: refused)
        "svt_banded_cost_scratch_bytes": ([_I] * 7, _LL),
    },
    "banded": {
        # C, s, dn, up, P, H, Wv, K, G, P1, P2, bytes, form, NT, S, stream
        "svt_banded_vertical": ([_P] * 4 + [_I] * 11 + [_P], _I),
        # device -> the shared memory a block may opt in to (-1: query failed)
        "svt_banded_smem_optin": ([_I], _I),
        # C, s, out, P, H, Wv, K, G, P1, P2, reverse, bytes, stream
        "svt_banded_horizontal": ([_P] * 3 + [_I] * 9 + [_P], _I),
    },
    "downsample": {
        # a, b (or null), out, P, H, W, fy, fx, stream
        "svt_downsample_box": ([_P] * 3 + [_I] * 5 + [_P], _I),
        # left, right, P, H, W, nlev, fy[], fx[], outs[], stream
        "svt_downsample_pyramid": ([_P] * 2 + [_I] * 4 + [_P] * 4, _I),
    },
    "banded_wta": {
        # v0..v3, nvol, minS, best, m2, m3, m4, uok, npix, K, uniq, sub, bytes, stream
        "svt_banded_wta": ([_P] * 4 + [_I] + [_P] * 6 + [_I] * 5 + [_P], _I),
        # v0..v3, nvol, s, pack, du, npix, K, uniq, bytes, stream
        "svt_banded_wta_fused": ([_P] * 4 + [_I] + [_P] * 3 + [_I] * 4 + [_P], _I),
    },
    "banded_diag": _DIAG_SIGNATURES,
    "banded_diag32": _DIAG_SIGNATURES,
    "banded_wide": _WIDE_SIGNATURES,
    "banded_wide32": _WIDE_SIGNATURES,
}


_LIBS: dict[str, ctypes.CDLL] = {}  # source -> its library, signatures set


def _lib(source: str = "banded") -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        lib = _build.library(source)
        for name, (argtypes, restype) in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIBS[source] = lib
    return lib


def _wide_lib(t: torch.Tensor) -> ctypes.CDLL:
    """The library of the scans and the WTA above K = 64 for t's storage type."""
    return _lib("banded_wide" if t.dtype == torch.int16 else "banded_wide32")


def _stream(t: torch.Tensor) -> int:
    return stream_handle(t)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def check_band(K: int) -> None:
    """The bands the CUDA kernels take: every K >= 1. The cost kernel, the
    scans (ring, group, cluster and strips forms; above 64 the wide forms)
    and the WTA all take any K; the fused WTA takes K = 16 only. A pixel's
    K lanes are stored in :func:`lane_stride` (K rounded up to 4) lanes, so
    that they start on a 4-lane word; the lanes past K hold nothing a kernel
    reads (:func:`lanes_view`). Bands above 64 spread a pixel's lanes over a
    group of 32 threads; above 1024 a warp walks them with its carry in
    device memory."""
    if K < 1:
        raise ValueError(f"the CUDA banded kernels take a band K >= 1, got {K}")


def lane_stride(K: int) -> int:
    """Lanes a pixel's band of K takes in the CUDA kernels' memory: K
    rounded up to a multiple of 4."""
    return -(-K // 4) * 4


def empty_lanes(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised (..., K) volume in the CUDA kernels' layout: a view
    of the first K lanes of a contiguous (..., lane_stride(K)) tensor (the
    whole tensor where K % 4 == 0)."""
    K = shape[-1]
    return torch.empty((*shape[:-1], lane_stride(K)), dtype=dtype, device=device)[..., :K]


def lanes_view(C: torch.Tensor) -> torch.Tensor:
    """C in the CUDA kernels' layout (see :func:`empty_lanes`): as given
    where it already is, else copied into it. A contiguous volume is in it
    where K % 4 == 0."""
    want = torch.empty((*C.shape[:-1], lane_stride(C.shape[-1])), device="meta").stride()
    if C.data_ptr() % 16 == 0 and all(a == b for a, b, d in zip(C.stride(), want, C.shape) if d > 1):
        return C
    out = empty_lanes(C.shape, C.dtype, C.device)
    out.copy_(C)
    return out


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
        if C.dtype not in (torch.int16, torch.int32):
            raise TypeError("the CUDA banded scans take an int16 or int32 volume")
        if C.shape[-1] % 4 == 0 and (not C.is_contiguous() or C.data_ptr() % 16):
            raise TypeError("the CUDA banded scans take a contiguous, 16-byte aligned volume")
        if C.dtype == torch.int16 and storage_dtype(cost_bound, P2, summed) == torch.int32:
            C = C.to(torch.int32)
        return lanes_view(C) if C.shape[-1] % 4 else C
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
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    dtype = cost_dtype(block_size, ftzero, dtype)
    kw = dict(band=band, G=G, ndisp=ndisp, ftzero=ftzero, block_size=block_size, min_x=min_x, stride=stride)
    if not _on_cuda(left):
        return banded_cost_plain(left, right, s, **kw, dtype=dtype)
    check_band(band)
    lib = _lib("banded_cost")
    # The kernel's rings take shared memory in proportion to its tile; the
    # tile shrinks until they fit, and where no tile fits they go to device
    # scratch.
    dev = device_index(left)
    tile = lib.svt_banded_cost_tile(band, ndisp, block_size, W - min_x, dev)
    nbytes = lib.svt_banded_cost_scratch_bytes(P, H, W - min_x, band, ndisp, block_size, dev) if tile == 0 else 0
    if tile < 0 or nbytes < 0:
        raise RuntimeError(f"svt_banded_cost: device query failed on {left.device}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=left.device) if tile == 0 else None
    left, right, s = left.contiguous(), right.contiguous(), s.contiguous()
    out = empty_lanes((P, H, W - min_x, band), dtype, left.device)
    err = lib.svt_banded_cost(left.data_ptr(), right.data_ptr(), s.data_ptr(), out.data_ptr(), P, H, W, band, G,
                              ndisp, block_size, ftzero, min_x, stride, tile, out.element_size(),
                              None if scratch is None else scratch.data_ptr(), _stream(left))
    _build.check(lib, err, "svt_banded_cost")
    banded_cost.launches += 1
    return out


# ------------------------------------------------------------------ scans


# The vertical scan's plan (#17). Forms: "ring" (no diagonals: a thread a
# chain, a ring of rows in shared memory), "group" (no diagonals, few chains
# of a wide band: a group of threads a chain), "cluster" (8 paths: a thread
# block cluster a chain), "strips" (8 paths, a width no cluster covers: one
# block a chain, its carry rows in device scratch), "wide" (K > 64:
# banded_wide.cu's kernels, planned there).
RING_THREADS = (256, 128, 64, 32)  # the ring form's block sizes, largest first
RING_DEPTHS = (2, 4, 8, 16)  # rows a ring holds
CLUSTER_SIZES = (16, 8, 4, 2, 1)
STRIP_THREADS = 256
GROUP_THREADS = 128  # the group form's block (csrc/banded_group.cuh kHorizThreads)
GROUP_BELOW = 64  # threads an SM: a ring form with fewer than these a SM takes the group form
DIAG_HALO = 32  # the cluster form's halo columns on each side of a block's own (csrc/banded_diag.cuh kDiagHalo)
IN_FLIGHT = 32 << 10  # bytes of reads an SM keeps in flight: ~20 KB streams 3.35 TB/s at ~0.8 us


def _pow2(K: int) -> int:
    """KP: the power of two at or above K (at least 4)."""
    return max(4, 1 << (K - 1).bit_length())


def diag_max_threads(K: int) -> int:
    """Threads a block of the cluster form may have at band K (its carries
    take ~4 KP registers a thread): ``csrc/banded_diag.cuh``'s."""
    kp = _pow2(K)
    return 1024 if kp <= 4 else 512 if kp <= 16 else 256 if kp == 32 else 128


def _ring_depth(row_bytes: int, per_sm: int, block_threads: int, smem_optin: int, read_bytes: int) -> int:
    """The fewest rows (a power of two from 2 to 16) that keep IN_FLIGHT
    bytes of reads (``read_bytes`` a thread and row) in flight on an SM
    running ``per_sm`` threads, their slots (``row_bytes`` a thread) within
    half the opt-in shared memory a block (so that two blocks fit an SM),
    else within all of it; 0 where even 2 rows do not fit."""
    for cap in (smem_optin // 2, smem_optin):
        fits = [S for S in RING_DEPTHS if S * row_bytes * block_threads <= cap]
        if fits:
            return next((S for S in fits if S * read_bytes * per_sm >= IN_FLIGHT), fits[-1])
    return 0


def vertical_plan(P: int, H: int, Wv: int, K: int, dtype: torch.dtype, with_diagonals: bool, *, sm_count: int,
                  smem_optin: int, active_clusters=None) -> dict:
    """How :func:`banded_vertical` launches #17 on a (P, H, Wv, K) volume of
    ``dtype`` (int16 or int32), chosen from the shape before the launch.

    ``sm_count`` and ``smem_optin`` describe the card (132 SMs and 232,448
    bytes on an H100); ``active_clusters(CS, NT, S)`` says how many clusters
    of CS blocks of NT threads with an S-row ring it holds at once (on the
    card the wrapper asks CUDA's occupancy calculator; without it, a model:
    the blocks an SM holds by threads and shared memory, times the SMs,
    over CS). Returns the form, ``threads`` (a block), ``cols_per_thread``,
    ``cols_per_block``, ``cluster`` (blocks a cluster), ``ring`` (rows),
    ``smem_bytes`` and ``scratch_bytes`` (a call), ``grid`` (blocks on x, y,
    z) and ``device_launches`` (1).

    - ring (no diagonals): a thread a (frame, column, direction), two
      columns where a band is 8 bytes; the block size (32 to 256 threads)
      whose busiest SM runs the fewest threads, the larger on ties;
    - group (no diagonals, K >= 16, where the ring form would run fewer
      than GROUP_BELOW threads an SM): a group of min(KP, 32) threads a
      (frame, column, direction), ``cols_per_block`` of them a block of
      GROUP_THREADS (the grid's x counts chains, down and up);
    - cluster (8 paths): a cluster of CS blocks a (frame, direction), each
      owning SW = ceil(Wv / CS) columns rounded up to a warp and running NT
      = SW + 2 * DIAG_HALO threads (SW for one block), at most
      :func:`diag_max_threads`; of the sizes the card holds, the one whose
      busiest SM walks the fewest columns a row (waves of clusters counted),
      the smaller size on ties;
    - strips (8 paths, where no cluster of at most 16 blocks covers Wv or
      the card holds none): one block a chain, carry rows in scratch.
    The ring's depth keeps ~32 KB of reads in flight an SM."""
    if dtype not in (torch.int16, torch.int32):
        raise TypeError(f"the CUDA banded scans store int16 or int32, not {dtype}")
    check_band(K)
    elem, chains = (2 if dtype == torch.int16 else 4), 2 * P
    ceil = lambda a, b: -(-a // b)
    plan = dict(form="", threads=0, cols_per_thread=1, cols_per_block=0, cluster=1, ring=0, smem_bytes=0,
                scratch_bytes=0, grid=(0, P, 2), device_launches=1)
    if K > WIDE_BAND:
        return dict(plan, form="wide")
    KP = _pow2(K)
    KS = lane_stride(K)
    cost_bytes = lambda cpt: (cpt * KS * elem + 15) // 16 * 16  # a thread's cost slot
    if not with_diagonals:
        cpt = 2 if KP * elem == 8 else 1
        row, read = cost_bytes(cpt) + 4 * cpt, cpt * (KS * elem + 4)
        threads = ceil(Wv, cpt)
        if KP >= 16 and chains * threads < sm_count * GROUP_BELOW:
            # Too few chains to fill the SMs a thread each: a group of
            # min(KP, 32) threads a chain (banded_group.cuh's line kernel).
            per_block = GROUP_THREADS // min(KP, 32)
            return dict(plan, form="group", threads=GROUP_THREADS, cols_per_block=per_block,
                        grid=(ceil(chains * Wv, per_block), 1, 1))
        # The threads the busiest SM runs at NT threads a block; the block
        # size that makes them fewest (blocks spread evenly, none mostly
        # idle), the larger on ties.
        busiest = lambda n: ceil(ceil(threads, n) * chains, sm_count) * n
        NT = min(RING_THREADS, key=lambda n: (busiest(n), -n))
        S = _ring_depth(row, min(2048, busiest(NT)), NT, smem_optin, read)
        while S == 0 and NT > 32:  # a band too wide for the ring at this block size
            NT //= 2
            S = _ring_depth(row, min(2048, busiest(NT)), NT, smem_optin, read)
        if S == 0:
            raise ValueError(f"the ring of band {K} fits no block in {smem_optin} bytes of shared memory")
        return dict(plan, form="ring", threads=NT, cols_per_thread=cpt, cols_per_block=NT * cpt, ring=S,
                    smem_bytes=S * NT * row, grid=(ceil(threads, NT), P, 2))
    row, read = cost_bytes(1) + 4, KS * elem + 4
    best = None
    for CS in CLUSTER_SIZES:
        SW = ceil(ceil(Wv, CS), 32) * 32  # a block's own columns, whole warps of them
        NT = SW + (2 * DIAG_HALO if CS > 1 else 0)
        if NT > diag_max_threads(K) or (CS > 1 and (CS - 1) * SW >= Wv):
            continue  # too wide a block, or a block with no column
        blocks_sm = ceil(chains * CS, sm_count)  # blocks an SM runs where every cluster is resident
        S = _ring_depth(row, min(2048, blocks_sm * NT), NT, smem_optin, read)
        smem = S * NT * row + 2 * (NT // 32) * 2 * (KP + 4) * 4 + (4 * DIAG_HALO * KP * 4 if CS > 1 else 0)
        if S == 0 or smem > smem_optin:
            continue
        if active_clusters is not None:
            active = active_clusters(CS, NT, S)
        else:
            per_sm = min(32, 2048 // NT, smem_optin // max(smem, 1))
            active = sm_count * per_sm // CS
        if active < 1:
            continue
        # Waves of clusters times the columns the busiest SM walks a row.
        cost = (ceil(chains, active) * ceil(min(chains, active) * CS, sm_count) * NT, CS)
        if best is None or cost < best[0]:
            best = (cost, dict(plan, form="cluster", threads=NT, cols_per_block=SW, cluster=CS, ring=S,
                               smem_bytes=smem, grid=(CS, P, 2)))
    if best is not None:
        return best[1]
    NT = min(STRIP_THREADS, ceil(Wv, 32) * 32)
    return dict(plan, form="strips", threads=NT, cols_per_block=Wv, scratch_bytes=12 * P * Wv * KS * elem,
                grid=(P, 2, 1))


_LIMITS: dict[int, tuple[int, int]] = {}  # device -> (SMs, opt-in shared memory a block)
_CLUSTERS: dict[tuple, int] = {}  # (device, dtype, K, CS, NT, S) -> clusters held at once


def device_plan(C: torch.Tensor, with_diagonals: bool) -> dict:
    """:func:`vertical_plan` for a CUDA volume C, with its card's limits and
    (8 paths) its occupancy calculator's clusters."""
    dev = device_index(C)
    if dev not in _LIMITS:
        optin = _lib().svt_banded_smem_optin(dev)
        if optin < 0:
            raise RuntimeError(f"svt_banded_smem_optin: device query failed on {C.device}")
        _LIMITS[dev] = (torch.cuda.get_device_properties(dev).multi_processor_count, optin)
    sm_count, optin = _LIMITS[dev]
    P, H, Wv, K = C.shape

    def active(CS, NT, S):
        key = (dev, C.dtype, K, CS, NT, S)
        if key not in _CLUSTERS:
            with torch.cuda.device(dev):
                _CLUSTERS[key] = _diag_lib(C).svt_banded_diag_clusters(K, CS, NT, S)
        return _CLUSTERS[key]

    return vertical_plan(P, H, Wv, K, C.dtype, with_diagonals, sm_count=sm_count, smem_optin=optin,
                         active_clusters=active)


def _diag_lib(t: torch.Tensor) -> ctypes.CDLL:
    """The library of the 8-path vertical for t's storage type."""
    return _lib("banded_diag" if t.dtype == torch.int16 else "banded_diag32")


def banded_vertical(C, s, G: int, P1: int, P2: int, *, cost_bound: int, with_diagonals: bool = False):
    """(P, H, Wv, K) banded cost + (P, H, Wv) shift map -> (down, up)
    direction volumes (int16 or int32 on CUDA, as :func:`_check_volume`
    stores them; int32 plain). With diagonals (8 paths) each volume is the
    sum of its set of three: vertical, (1,1) and (-1,1) carries (the up set
    scans the y-flipped volume with the same column shifts).

    On CUDA one device launch a call, by :func:`vertical_plan` (the last
    call's in ``banded_vertical.plan``); ``launches`` counts the calls that
    launched, ``diagonal_launches`` those with diagonals."""
    C = _check_volume(C, P2, cost_bound, 3 if with_diagonals else 1)
    if P1 < 0 or P2 < 0:
        raise ValueError("P1 and P2 must be >= 0")
    if not _on_cuda(C):
        return vertical_plain(C, s, G, P1, P2, with_diagonals)
    s = _check_shift(s, C)
    P, H, Wv, K = C.shape
    dn, up = (empty_lanes(C.shape, C.dtype, C.device) for _ in range(2))
    if C.numel() == 0:
        return dn, up
    if K > WIDE_BAND:
        lib = _wide_lib(C)
        nbytes = lib.svt_banded_wide_diag_scratch_bytes(P, Wv, K, device_index(C)) if with_diagonals else 0
        if nbytes < 0:
            raise RuntimeError(f"svt_banded_wide_diag_scratch_bytes: device query failed on {C.device}")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=C.device) if nbytes else None
        err = lib.svt_banded_wide_vertical(C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr(),
                                           None if scratch is None else scratch.data_ptr(), P, H, Wv, K, G, P1, P2,
                                           int(with_diagonals), _stream(C))
        _build.check(lib, err, "svt_banded_wide_vertical")
        banded_vertical.plan = dict(form="wide", device_launches=1)
    else:
        plan = device_plan(C, with_diagonals)
        if with_diagonals:
            lib = _diag_lib(C)
            nbytes = plan["scratch_bytes"]
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=C.device) if nbytes else None
            err = lib.svt_banded_vertical_diag(C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr(),
                                               None if scratch is None else scratch.data_ptr(), P, H, Wv, K, G, P1,
                                               P2, 0 if plan["form"] == "cluster" else 1, plan["cluster"],
                                               plan["threads"], plan["ring"], _stream(C))
            _build.check(lib, err, "svt_banded_vertical_diag")
        else:
            lib = _lib()
            err = lib.svt_banded_vertical(C.data_ptr(), s.data_ptr(), dn.data_ptr(), up.data_ptr(), P, H, Wv, K, G,
                                          P1, P2, C.element_size(), 0 if plan["form"] == "ring" else 1,
                                          plan["threads"], plan["ring"], _stream(C))
            _build.check(lib, err, "svt_banded_vertical")
        banded_vertical.plan = plan
    banded_vertical.diagonal_launches += int(with_diagonals)
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
    out = empty_lanes(C.shape, C.dtype, C.device)
    if K > WIDE_BAND:
        lib = _wide_lib(C)
        err = lib.svt_banded_wide_horizontal(C.data_ptr(), s.data_ptr(), out.data_ptr(), P, H, Wv, K, G, P1, P2,
                                             int(reverse), _stream(C))
        _build.check(lib, err, "svt_banded_wide_horizontal")
    else:
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


def _check_wta_volumes(volumes: list, what: str) -> list:
    """2-4 (P, H, Wv, K >= 1) volumes of one shape on one device; on CUDA,
    of one type (int16 or int32), contiguous and aligned where K % 4 == 0,
    with fewer than 2^31 pixels. Returns them, on CUDA in the kernels'
    layout (:func:`lanes_view`)."""
    v0 = volumes[0]
    if not 2 <= len(volumes) <= 4 or any(v.shape != v0.shape or v.device != v0.device for v in volumes):
        raise ValueError(f"{what} takes 2-4 direction volumes of one shape on one device")
    if v0.dim() != 4 or v0.shape[-1] < 1:
        raise ValueError(f"expected (P, H, Wv, K>=1) volumes, got {tuple(v0.shape)}")
    if _on_cuda(v0):
        check_band(v0.shape[-1])
        if v0.dtype not in (torch.int16, torch.int32) or any(v.dtype != v0.dtype for v in volumes):
            raise TypeError(f"the CUDA kernel of {what} takes volumes of one type, int16 or int32")
        if v0.shape[-1] % 4 == 0 and any(not v.is_contiguous() or v.data_ptr() % 16 for v in volumes):
            raise TypeError(f"the CUDA kernel of {what} takes contiguous, 16-byte aligned volumes")
        if v0.shape[:3].numel() >= 1 << 31:
            raise ValueError(f"the CUDA kernel of {what} takes fewer than 2^31 pixels a call")
        if v0.shape[-1] % 4:
            return [lanes_view(v) for v in volumes]
    return volumes


def banded_wta(volumes, uniqueness_ratio: int, sub: bool = False):
    """Sum 2-4 (P, H, Wv, K) direction volumes and reduce over the K lanes:
    (minS, best_k, sm, s0, sp, unique_ok), or with ``sub`` (minS, best_k,
    sub16, unique_ok) where sub16 is the subpixel parabola in lane units
    (``ndisp = K``). Maps are int32, ``unique_ok`` bool; ties go to the
    smallest k, uniqueness is band-local (|k - best| > 1)."""
    volumes = _check_wta_volumes(list(volumes), "banded_wta")
    v0 = volumes[0]
    if not _on_cuda(v0):
        return banded_wta_plain(volumes, uniqueness_ratio, sub)
    P, H, Wv, K = v0.shape
    maps = [torch.empty((P, H, Wv), dtype=torch.int32, device=v0.device) for _ in range(3 if sub else 5)]
    uok = torch.empty((P, H, Wv), dtype=torch.bool, device=v0.device)
    ptrs = [v.data_ptr() for v in volumes] + [None] * (4 - len(volumes))
    mptrs = [m.data_ptr() for m in maps] + [None] * (5 - len(maps))
    if K > WIDE_BAND:
        lib = _wide_lib(v0)
        err = lib.svt_banded_wide_wta(*ptrs, len(volumes), *mptrs, uok.data_ptr(), P * H * Wv, K, uniqueness_ratio,
                                      int(sub), _stream(v0))
        _build.check(lib, err, "svt_banded_wide_wta")
    else:
        lib = _lib("banded_wta")
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
    volumes = _check_wta_volumes(list(volumes), "banded_wta_fused")
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
    lib = _lib("banded_wta")
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
    if min_x >= left.shape[-1]:
        # No column in the region (a frame no wider than the level's range):
        # the reference's maps are empty, and no kernel runs.
        empty = lambda dtype: torch.empty((*left.shape[:2], 0), dtype=dtype, device=left.device)
        if fused:
            return empty(torch.int32), empty(torch.int32)
        return (*(empty(torch.int32) for _ in range(3 if sub else 5)), empty(torch.bool))
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
    lib = _lib("downsample")
    err = lib.svt_downsample_box(img.data_ptr(), None, out.data_ptr(), P, H, W, fy, fx, _stream(img))
    _build.check(lib, err, "svt_downsample_box")
    downsample_box.launches += 1
    return out


PYRAMID_MAX_LEVELS = 8  # levels one launch of the pyramid kernel takes


def pyramid_nests(factors) -> bool:
    """Whether one launch of the pyramid kernel computes every level of
    ``factors`` from one read of the frames: every factor a power of two,
    fy <= 16 and fx <= 128, at most 8 levels, and the levels ordered by fy
    also ordered by fx (so that each level's blocks are unions of the
    next finer level's). Every main path's ((4, 4), (2, 2)) nests."""
    if not 0 < len(factors) <= PYRAMID_MAX_LEVELS:
        return False
    if any(f & (f - 1) for pair in factors for f in pair) or any(fy > 16 or fx > 128 for fy, fx in factors):
        return False
    ordered = sorted(factors)
    return all(a[1] <= b[1] for a, b in zip(ordered, ordered[1:]))


def downsample_pyramid_plain(left: torch.Tensor, right: torch.Tensor, factors) -> tuple:
    """Plain form of :func:`downsample_pyramid`: :func:`downsample_box_plain`
    per image and per level."""
    return tuple((downsample_box_plain(left, fy, fx), downsample_box_plain(right, fy, fx)) for fy, fx in factors)


_PYRAMID_ORDERS: dict[tuple, tuple | None] = {}  # factors -> the kernel's level order (finest first), or None


def _pyramid_order(factors: tuple) -> tuple | None:
    """The order in which one launch takes the levels of ``factors`` (None:
    they do not nest), with its factor arrays, cached: the wrapper's host
    time shows beside a small call's ~25 us of device time."""
    if factors not in _PYRAMID_ORDERS:
        if any(fy < 1 or fx < 1 for fy, fx in factors):
            raise ValueError(f"bad level factors {factors}")
        order = None
        if pyramid_nests(factors):
            idx = sorted(range(len(factors)), key=lambda i: factors[i])
            n = len(idx)
            order = (idx, (ctypes.c_int * n)(*(factors[i][0] for i in idx)),
                     (ctypes.c_int * n)(*(factors[i][1] for i in idx)))
        _PYRAMID_ORDERS[factors] = order
    return _PYRAMID_ORDERS[factors]


def downsample_pyramid(left: torch.Tensor, right: torch.Tensor, factors) -> tuple:
    """(P, H, W) int32 left and right frames and a tuple of (fy, fx) level
    factors -> each level's (lc, rc), the box means of :func:`downsample_box`
    (each level's (P, H // fy, W // fx) pair). On the card both images and
    every level take one launch where the factors nest
    (:func:`pyramid_nests`), else one launch a level, both images a launch;
    a coarse level's mean comes from the integer block sums, never from a
    finer level's rounded values."""
    factors = tuple(tuple(f) for f in factors)
    if left.dim() != 3 or left.dtype != torch.int32 or right.dtype != torch.int32 or right.shape != left.shape:
        raise ValueError(f"expected two (P, H, W) int32 frame sets of one shape, got {tuple(left.shape)} "
                         f"{left.dtype} and {tuple(right.shape)} {right.dtype}")
    if left.device != right.device:
        raise ValueError("the pyramid's frames lie on different devices")
    if not factors:
        raise ValueError("no level factors")
    order = _pyramid_order(factors)
    if not _on_cuda(left):
        return downsample_pyramid_plain(left, right, factors)
    P, H, W = left.shape
    left, right = left.contiguous(), right.contiguous()
    outs = [torch.empty((2, P, H // fy, W // fx), dtype=torch.int32, device=left.device) for fy, fx in factors]
    lib, stream = _lib("downsample"), _stream(left)
    if P * H * W and order is not None:
        idx, fys, fxs = order
        ptrs = (ctypes.c_void_p * len(idx))(*(outs[i].data_ptr() for i in idx))
        err = lib.svt_downsample_pyramid(left.data_ptr(), right.data_ptr(), P, H, W, len(idx), fys, fxs, ptrs, stream)
        _build.check(lib, err, "svt_downsample_pyramid")
        downsample_pyramid.launches += any(o.numel() for o in outs)
    elif P * H * W:
        for (fy, fx), o in zip(factors, outs):
            if o.numel():
                err = lib.svt_downsample_box(left.data_ptr(), right.data_ptr(), o.data_ptr(), P, H, W, fy, fx, stream)
                _build.check(lib, err, "svt_downsample_box")
                downsample_pyramid.launches += 1
    return tuple(o.unbind(0) for o in outs)


banded_cost.launches = 0
banded_vertical.launches = 0
banded_vertical.diagonal_launches = 0
banded_vertical.plan = None
banded_horizontal.launches = 0
banded_wta.launches = 0
banded_wta_fused.launches = 0
downsample_box.launches = 0
downsample_pyramid.launches = 0
