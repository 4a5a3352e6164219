"""Semi-global aggregation + winner-take-all: plain PyTorch forms + CUDA kernels.

Replaces the entry points of ``stereo_vision_tpu/stereo/sgm_pallas.py``
(``sgm_reduce_pallas``, ``aggregate_8_pallas``, ``wta_stats_pallas``) and
their kernel bodies:

- ``_vertical_kernel``  -> :func:`vertical`   (``csrc/sgm.cu`` vertical_cluster)
- ``_horizontal_kernel`` -> :func:`horizontal` (``csrc/sgm.cu`` horizontal_scan)
- ``_wta4_kernel``      -> :func:`wta4`       (``csrc/sgm.cu`` wta_kernel)
- ``_wta_kernel``       -> :func:`wta_stats`  (``csrc/sgm.cu`` wta_stats_kernel)
- ``_horizontal_rl_wta_kernel`` -> :func:`horizontal_rl_wta`
  (``csrc/sgm.cu`` horizontal_rl_wta, launched as :func:`rl_wta_plan`
  says), taken by :func:`sgm_reduce` when ``_FUSED_RL_WTA`` is set
- ``aggregate_8_pallas`` -> :func:`aggregate_8` (the vertical and horizontal
  kernels, their int16 volumes summed into one int32 volume)

Each wrapper launches its kernel for CUDA tensors and runs its plain form
(the scan reference of ``stereo_vision_tpu/stereo/sgbm.py``) for CPU ones.
The kernels serve every ``num_paths`` in {2, 3, 4, 8}: 2 = vertical pair
without diagonals, 3 adds L->R, 4 adds R->L, 8 adds the four diagonals.

Integer ranges: with P1, P2 >= 0 every aggregated value satisfies
``c <= L <= c + P2`` (the candidate min never exceeds ``minL + P2``), so a
direction volume is bounded by ``cost_bound + P2`` and the three-direction
set sum by ``3 * (cost_bound + P2)``. Each kernel has an int16 and an int32
form; the wrappers store costs, carries and direction volumes as int16
where that bound fits and as int32 otherwise (:func:`storage_dtype`), one
type for a whole call. The plain forms keep int32.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_vision_tpu_torch import _build
from stereo_vision_tpu_torch.device import device_index, stream_handle

_BIG = 1 << 29  # out-of-range d±1 neighbour: far above any reachable L
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # C, s_dn, s_up, scratch, B, H, W, D, P1, P2, with_diag, bytes, plan (8 long longs), stream
    "svt_sgm_vertical": [_P] * 4 + [_I] * 8 + [_P, _P],
    # B, H, W, D, bytes, plan out (8 long longs)
    "svt_sgm_vertical_plan": [_I] * 5 + [_P],
    # C, s_dn, s_up, B, H, W, D, P1, P2, cluster, warps, columns a warp, stream
    "svt_sgm_vertical_registers": [_P] * 3 + [_I] * 9 + [_P],
    # D, columns a warp -> warps a block of the register form (0: not built / spills)
    "svt_sgm_vertical_registers_warps": [_I] * 2,
    # D, columns a warp, warps, cluster -> clusters the card holds at once (one block an SM)
    "svt_sgm_vertical_registers_clusters": [_I] * 4,
    # C, out, B, H, W, D, P1, P2, reverse, bytes, stream
    "svt_sgm_horizontal": [_P] * 2 + [_I] * 8 + [_P],
    # v0..v3, nvol, minS, best, sm, s0, sp, uok, npix, D, uniq, bytes, stream
    "svt_sgm_wta": [_P] * 4 + [_I] + [_P] * 6 + [_I] * 4 + [_P],
    # S, minS, best, sm, s0, sp, uok, npix, D, uniq, stream
    "svt_sgm_wta_stats": [_P] * 7 + [ctypes.c_longlong] + [_I] * 2 + [_P],
    # C, v0, v1, v2, minS, best, sm, s0, sp, uok, B, H, W, D, P1, P2, uniq, bytes, Lbuf, stream
    "svt_sgm_horizontal_rl_wta": [_P] * 10 + [_I] * 8 + [_P, _P],
    # D, bytes, plan out (4 long longs)
    "svt_sgm_rl_wta_plan": [_I] * 2 + [_P],
}
_QUERIES = {
    # B, H, D, bytes -> bytes of the fused R->L WTA's carry rows (0: in registers)
    "svt_sgm_rl_wta_scratch_bytes": [_I] * 4,
}
# Fuse the R->L scan with the WTA in sgm_reduce (horizontal_rl_wta), as
# sgm_pallas._FUSED_RL_WTA does in the JAX package, and off by default as
# there: the fused form saves the fourth direction volume's write and read,
# and runs the WTA's reductions beside the scan's serial column chain.
_FUSED_RL_WTA = False


# The fields of svt_sgm_vertical_plan: the cluster size (0: the wide form's
# row launches), columns a block, warps a block, carries in shared memory (1)
# or in scratch (0), clusters the card holds at once, shared-memory bytes a
# block, scratch bytes, device launches.
_PLAN_FIELDS = ("cluster", "columns", "warps", "carries_in_smem", "active_clusters", "smem_bytes", "scratch_bytes",
                "device_launches")
# (device, B, H, W, D, bytes, words) -> the plan, and the cluster form's
# plan as svt_sgm_vertical takes it (None for the register form).
_plans: dict[tuple, tuple[dict, ctypes.Array | None]] = {}
# The forms of the vertical scan (#2), as vertical_plan names them and
# vertical.launches_by_form counts them: "registers", a warp's columns'
# carries in registers for the whole scan (the packed int16 step with
# diagonals at D = 64, 128, 256, :func:`packed_words`); "shared" and
# "scratch", the cluster kernel with a block's carry rows in shared memory
# or in device scratch (every other scan up to 1024 disparities); "wide", a
# launch a row above.
FORMS = ("registers", "shared", "scratch", "wide")
# Columns a warp the register form is built for (csrc/sgm.cu reg_built), by
# the 32-bit words a lane holds of a D-vector (D / 64: 1, 2, 4).
REGISTER_COLUMNS = {1: (*range(1, 13), 14, 16), 2: (*range(1, 13), 14, 16), 4: tuple(range(1, 9))}
# The register form's model of a block's row (an SM's, one block an SM), in
# cycles: each of the SM's four schedulers issues ~COLUMN_ISSUE instructions
# a column for ceil(warps / 4) warps, and a warp takes at least
# ~COLUMN_LATENCY cycles a column (its three steps' dependent chains), plus
# ~ROW_CYCLES a row (the edge exchange). Fitted to one H100's rows at B = 1
# (PERF.md).
COLUMN_ISSUE, COLUMN_LATENCY, ROW_CYCLES = 100, 350, 600
_REG_LIMITS: dict[tuple, int] = {}  # (device, D, columns a warp) -> warps a block
_REG_CLUSTERS: dict[tuple, int] = {}  # (device, D, columns a warp, warps, cluster) -> clusters at once
# The fields of svt_sgm_rl_wta_plan (the fused R->L WTA's launch): its form
# (_RL_FORMS), rows (warps) a block, ring columns a row, shared-memory bytes
# a block.
_RL_PLAN_FIELDS = ("form", "rows_per_block", "ring", "smem_bytes")
_RL_FORMS = ("direct", "ring", "wide")
_rl_plans: dict[tuple, dict] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.library("sgm")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for name, argtypes in _QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_longlong
    return lib


# ---------------------------------------------------------------- plain forms


def _sgm_update(c, L, minL, P1: int, P2: int):
    """One SGM step: L' = c + min(L, L(d-1)+P1, L(d+1)+P1, minL+P2) - minL."""
    big = torch.full_like(L[..., :1], _BIG)
    Lm = torch.cat([big, L[..., :-1]], dim=-1)
    Lp = torch.cat([L[..., 1:], big], dim=-1)
    cand = torch.minimum(torch.minimum(L, minL + P2), torch.minimum(Lm, Lp) + P1)
    Lnew = c + cand - minL
    return Lnew, Lnew.amin(dim=-1, keepdim=True)


def _shift_cols(a, direction: int):
    """Shift along the column axis (-2) of (..., W, D), zero fill:
    direction > 0 moves column x-1 to x, < 0 moves x+1 to x."""
    if direction == 0:
        return a
    z = torch.zeros_like(a[..., :1, :])
    if direction > 0:
        return torch.cat([z, a[..., :-1, :]], dim=-2)
    return torch.cat([a[..., 1:, :], z], dim=-2)


def _aggregate_down(C, P1: int, P2: int, with_diagonals: bool = True):
    """Sum of the downward direction volumes over (N, H, W, D) int32 costs:
    (0,1) plus, with diagonals, (1,1) and (-1,1). A zero carry (L = 0,
    min = 0) makes the first row's L equal its cost row."""
    N, H, W, D = C.shape
    zero = torch.zeros((N, W, D), dtype=C.dtype, device=C.device)
    zmin = torch.zeros((N, W, 1), dtype=C.dtype, device=C.device)
    (Lv, mv), (Ld, md), (Lu, mu) = (zero, zmin), (zero, zmin), (zero, zmin)
    S = torch.empty_like(C)
    for y in range(H):
        c = C[:, y]
        Lv, mv = _sgm_update(c, Lv, mv, P1, P2)
        if with_diagonals:
            Ld, md = _sgm_update(c, _shift_cols(Ld, 1), _shift_cols(md, 1), P1, P2)
            Lu, mu = _sgm_update(c, _shift_cols(Lu, -1), _shift_cols(mu, -1), P1, P2)
            S[:, y] = Lv + Ld + Lu
        else:
            S[:, y] = Lv
    return S


def _aggregate_horiz(C, P1: int, P2: int):
    """Left-to-right direction volume over (N, H, W, D) int32 costs."""
    N, H, W, D = C.shape
    L = torch.zeros((N, H, D), dtype=C.dtype, device=C.device)
    m = torch.zeros((N, H, 1), dtype=C.dtype, device=C.device)
    S = torch.empty_like(C)
    for x in range(W):
        L, m = _sgm_update(C[:, :, x], L, m, P1, P2)
        S[:, :, x] = L
    return S


def vertical_plain(C, P1: int, P2: int, with_diagonals: bool = True):
    """Plain form of :func:`vertical`: (down-set sum, up-set sum), int32.
    The up set scans the y-flipped volume with the SAME column shifts."""
    C = C.to(torch.int32)
    S = _aggregate_down(torch.cat([C, C.flip(-3)]), P1, P2, with_diagonals)
    B = C.shape[0]
    return S[:B], S[B:].flip(-3)


def horizontal_plain(C, P1: int, P2: int, reverse: bool = False):
    """Plain form of :func:`horizontal`: the L->R (or R->L) volume, int32."""
    C = C.to(torch.int32)
    if reverse:
        return _aggregate_horiz(C.flip(-2), P1, P2).flip(-2)
    return _aggregate_horiz(C, P1, P2)


LANE_FILL = -(1 << 31)  # what the reference's take_along_axis reads outside [-D, D)


def _take_lane(S, i):
    """S[..., i] with the reference's ``jnp.take_along_axis`` rule: an index
    in [-D, 0) counts from the end, one outside [-D, D) reads LANE_FILL.
    Only bands below 3 reach either (the WTA's clamped samples)."""
    D = S.shape[-1]
    j = torch.where(i < 0, i + D, i)
    inside = (j >= 0) & (j < D)
    v = torch.gather(S, -1, j.clamp(0, D - 1)[..., None])[..., 0]
    return torch.where(inside, v, torch.full_like(v, LANE_FILL))


def wta_scan(S, ndisp: int, uniqueness_ratio: int):
    """WTA + uniqueness + subpixel samples from an aggregated (..., D)
    volume: (minS, best, sm, s0, sp, unique_ok); ties go to the smallest d."""
    minS, best = S.min(dim=-1)  # torch returns the first minimal index
    if uniqueness_ratio > 0:
        ds = torch.arange(ndisp, device=S.device)
        offender = (minS[..., None] * (100 + uniqueness_ratio) > S * 100) & (
            (ds - best[..., None]).abs() > 1
        )
        unique_ok = ~offender.any(dim=-1)
    else:
        unique_ok = torch.ones_like(best, dtype=torch.bool)
    d0 = best.clamp(1, ndisp - 2)  # clamp(best, 1, -1) == -1 at ndisp 1, 0 at ndisp 2
    s0, sm, sp = _take_lane(S, d0), _take_lane(S, d0 - 1), _take_lane(S, d0 + 1)
    i32 = lambda a: a.to(torch.int32)
    return i32(minS), i32(best), i32(sm), i32(s0), i32(sp), unique_ok


def wta4_plain(volumes, uniqueness_ratio: int):
    """Plain form of :func:`wta4`: WTA stats over the sum of the volumes."""
    S = volumes[0].to(torch.int32)
    for v in volumes[1:]:
        S = S + v.to(torch.int32)
    return wta_scan(S, S.shape[-1], uniqueness_ratio)


def _aggregate_8(C, P1: int, P2: int, num_paths: int = 8):
    """Aggregated int32 volume over 8, 4, 3 or 2 directions: the scan
    reference's ``_aggregate_8`` and the plain form of :func:`aggregate_8`
    (:func:`sgm_reduce` never forms it)."""
    s_dn, s_up = vertical_plain(C, P1, P2, with_diagonals=num_paths >= 8)
    S = s_dn + s_up
    if num_paths >= 3:
        S = S + horizontal_plain(C, P1, P2)
    if num_paths >= 4:
        S = S + horizontal_plain(C, P1, P2, reverse=True)
    return S


def horizontal_rl_wta_plain(C, s_dn, s_up, s_lr, P1: int, P2: int, uniqueness_ratio: int):
    """Plain form of :func:`horizontal_rl_wta`: the R->L volume, then the
    WTA over the four volumes."""
    return wta4_plain([s_dn, s_up, s_lr, horizontal_plain(C, P1, P2, reverse=True)], uniqueness_ratio)


def sgm_reduce_plain(C, P1: int, P2: int, uniqueness_ratio: int, num_paths: int = 8):
    """Plain form of :func:`sgm_reduce`."""
    return wta_scan(_aggregate_8(C, P1, P2, num_paths), C.shape[-1], uniqueness_ratio)


# ------------------------------------------------------------------ wrappers


def storage_dtype(cost_bound: int, P2: int, ndir: int) -> torch.dtype:
    """The type the kernels store costs and direction volumes in: int16
    where a stored value, the sum of ``ndir`` carries (3 for an 8-path
    vertical set), is bounded below 2^15, int32 otherwise."""
    return torch.int16 if ndir * (cost_bound + P2) < 1 << 15 else torch.int32


def _check_volume(C: torch.Tensor, P1: int, P2: int, cost_bound: int, ndir: int) -> torch.Tensor:
    """C as the kernels store it: int32 where it is int32 or where
    :func:`storage_dtype` needs it, else int16 (CPU tensors as given)."""
    if C.dim() != 4:
        raise ValueError(f"expected a (B, H, W, D) cost volume, got {tuple(C.shape)}")
    if P1 < 0 or P2 < 0:
        raise ValueError("P1 and P2 must be >= 0")
    if C.device.type == "cuda":
        if C.dtype not in (torch.int16, torch.int32) or not C.is_contiguous():
            raise TypeError("the CUDA SGM kernels take a contiguous int16 or int32 cost volume")
        if C.dtype == torch.int16 and storage_dtype(cost_bound, P2, ndir) == torch.int32:
            return C.to(torch.int32)
    elif C.device.type != "cpu":
        raise ValueError(f"unsupported device {C.device}")
    return C


def _stream(t: torch.Tensor) -> int:
    return stream_handle(t)


def _maps(like: torch.Tensor):
    """Five int32 (B, H, W) maps and a bool one for a (B, H, W, D) volume."""
    shape = like.shape[:-1]
    return [torch.empty(shape, dtype=torch.int32, device=like.device) for _ in range(5)], \
        torch.empty(shape, dtype=torch.bool, device=like.device)


def packed_words(D: int, dtype: torch.dtype, with_diagonals: bool, P1: int) -> int:
    """The 32-bit words a lane holds of a D-vector in the register form of
    the vertical scan (1, 2 or 4), or 0 where the form does not apply: it is
    the packed int16 step (two values a word, P1 <= 0x7fff) with diagonals,
    at D = 64, 128 or 256 (every lane's 2, 4 or 8 values real)."""
    if dtype != torch.int16 or not with_diagonals or D not in (64, 128, 256) or P1 > 0x7FFF:
        return 0
    return D // 64


def register_plan(B: int, W: int, D: int, *, active_clusters, max_warps) -> dict | None:
    """The register form's launch for B frames of W columns of D disparities
    (D packable, :func:`packed_words`), or None where no cluster of at most
    16 blocks holds W columns in registers.

    A chain (frame, set) is a cluster of ``cluster`` blocks, one block an SM;
    a block has ``warps`` warps, a warp ``cols_per_warp`` consecutive columns
    (the last warps of the chain fewer or none). ``max_warps(cpw)`` says how
    many warps a block of cpw columns a warp may have (0: none),
    ``active_clusters(cs, nw, cpw)`` how many such clusters the card holds
    at once. Of the splits that cover W, the one whose waves of clusters
    times its modelled row (COLUMN_ISSUE, COLUMN_LATENCY, ROW_CYCLES) is least,
    then the fewer waves, the smaller cluster, the fewer columns a warp.
    Returns the fields of ``_PLAN_FIELDS`` and ``form``, ``cols_per_warp``,
    ``waves`` and ``sms`` (the SMs of the first wave)."""
    words = D // 64
    chains = 2 * B
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    best = None
    for cpw in REGISTER_COLUMNS[words]:
        nw_max = max_warps(cpw)
        for cs in range(1, 17):
            nw = ceil(W, cs * cpw)
            if nw > nw_max or (cs - 1) * nw * cpw >= W:
                continue  # too many warps for a block, or a block with no column
            active = active_clusters(cs, nw, cpw)
            if active < 1:
                continue
            waves = ceil(chains, active)
            row = max(ceil(nw, 4) * cpw * COLUMN_ISSUE, cpw * COLUMN_LATENCY) + ROW_CYCLES
            key = (waves * row, waves, cs, cpw)
            if best is None or key < best[0]:
                best = (key, dict(cluster=cs, columns=nw * cpw, warps=nw, carries_in_smem=0, active_clusters=active,
                                  smem_bytes=0, scratch_bytes=0, device_launches=1, form="registers",
                                  cols_per_warp=cpw, waves=waves, sms=min(chains, active) * cs))
    return None if best is None else best[1]


def _device_register_plan(C: torch.Tensor) -> dict | None:
    """:func:`register_plan` for the CUDA volume C, with the warps each build
    of the form allows on its card (launch bounds, registers, no spills) and
    its occupancy calculator's clusters."""
    lib = _lib()
    dev = device_index(C)
    B, H, W, D = C.shape

    def max_warps(cpw: int) -> int:
        key = (dev, D, cpw)
        if key not in _REG_LIMITS:
            with torch.cuda.device(dev):
                _REG_LIMITS[key] = lib.svt_sgm_vertical_registers_warps(D, cpw)
        return _REG_LIMITS[key]

    def active(cs: int, nw: int, cpw: int) -> int:
        key = (dev, D, cpw, nw, cs)
        if key not in _REG_CLUSTERS:
            with torch.cuda.device(dev):
                _REG_CLUSTERS[key] = max(0, lib.svt_sgm_vertical_registers_clusters(D, cpw, nw, cs))
        return _REG_CLUSTERS[key]

    return register_plan(B, W, D, active_clusters=active, max_warps=max_warps)


def _plan(C: torch.Tensor, with_diagonals: bool, P1: int) -> tuple[dict, ctypes.Array | None]:
    """:func:`vertical_plan`'s plan, cached by device, shape, type and form,
    with the cluster form's long longs for svt_sgm_vertical."""
    B, H, W, D = C.shape
    words = packed_words(D, C.dtype, with_diagonals, P1)
    key = (device_index(C), B, H, W, D, C.element_size(), words)
    entry = _plans.get(key)
    if entry is None:
        plan, out = _device_register_plan(C) if words else None, None
        if plan is None:
            lib = _lib()
            out = (ctypes.c_longlong * len(_PLAN_FIELDS))()
            with torch.cuda.device(C.device):
                err = lib.svt_sgm_vertical_plan(B, H, W, D, C.element_size(), out)
            _build.check(lib, err, "svt_sgm_vertical_plan")
            plan = dict(zip(_PLAN_FIELDS, out))
            plan["form"] = "wide" if plan["cluster"] == 0 else "shared" if plan["carries_in_smem"] else "scratch"
        entry = _plans[key] = (plan, out)
    return entry


def vertical_plan(C: torch.Tensor, with_diagonals: bool = True, P1: int = 0) -> dict:
    """How :func:`vertical` launches on a (B, H, W, D) CUDA cost volume
    stored as C is (with or without diagonals, at P1): the fields of
    ``_PLAN_FIELDS`` and ``form`` (:data:`FORMS`; the register form also
    ``cols_per_warp``, ``waves`` and ``sms``, :func:`register_plan`). One
    device launch, or above 1024 disparities H row launches."""
    return dict(_plan(C, with_diagonals, P1)[0])


def vertical(C, P1: int, P2: int, with_diagonals: bool, cost_bound: int):
    """(B, H, W, D) cost -> (down-set sum, up-set sum) volumes.

    On CUDA one launch of a thread block cluster a (frame, set) walks the H
    rows, by :func:`vertical_plan`'s form (counted in ``vertical.launches``
    and, by form, ``vertical.launches_by_form``; ``vertical.device_launches``
    counts device launches: 1 a call, H above 1024 disparities;
    ``vertical.plan`` is the last call's plan)."""
    C = _check_volume(C, P1, P2, cost_bound, 3 if with_diagonals else 1)
    if C.device.type == "cpu":
        return vertical_plain(C, P1, P2, with_diagonals)
    B, H, W, D = C.shape
    s_dn = torch.empty_like(C)
    s_up = torch.empty_like(C)
    if C.numel() == 0:
        return s_dn, s_up
    plan, out = _plan(C, with_diagonals, P1)
    lib = _lib()
    if out is None:  # the register form
        err = lib.svt_sgm_vertical_registers(C.data_ptr(), s_dn.data_ptr(), s_up.data_ptr(), B, H, W, D, P1, P2,
                                             plan["cluster"], plan["warps"], plan["cols_per_warp"], _stream(C))
        _build.check(lib, err, "svt_sgm_vertical_registers")
    else:
        nbytes = plan["scratch_bytes"]
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=C.device) if nbytes else None
        err = lib.svt_sgm_vertical(C.data_ptr(), s_dn.data_ptr(), s_up.data_ptr(),
                                   None if scratch is None else scratch.data_ptr(), B, H, W, D, P1, P2,
                                   int(with_diagonals), C.element_size(), out, _stream(C))
        _build.check(lib, err, "svt_sgm_vertical")
    vertical.launches += 1
    vertical.launches_by_form[plan["form"]] += 1
    vertical.device_launches += plan["device_launches"]
    vertical.plan = dict(plan)
    return s_dn, s_up


def horizontal(C, P1: int, P2: int, reverse: bool, cost_bound: int):
    """(B, H, W, D) cost -> the L->R (``reverse``: R->L) direction volume."""
    C = _check_volume(C, P1, P2, cost_bound, 1)
    if C.device.type == "cpu":
        return horizontal_plain(C, P1, P2, reverse)
    B, H, W, D = C.shape
    out = torch.empty_like(C)
    lib = _lib()
    err = lib.svt_sgm_horizontal(C.data_ptr(), out.data_ptr(), B, H, W, D, P1, P2, int(reverse), C.element_size(),
                                 _stream(C))
    _build.check(lib, err, "svt_sgm_horizontal")
    horizontal.launches += 1
    return out


def wta4(volumes, uniqueness_ratio: int):
    """Sum 2-4 (B, H, W, D) direction volumes and reduce over D to
    (minS, best, sm, s0, sp, unique_ok): int32 maps and a bool map.
    ``best`` takes the smallest d on ties; ``sm/s0/sp`` sample the sum at
    ``clip(best, 1, D-2)`` and its neighbours; ``unique_ok`` is false when
    some d with |d - best| > 1 has ``minS*(100+U) > S*100``."""
    volumes = list(volumes)
    v0 = volumes[0]
    if not 2 <= len(volumes) <= 4 or any(v.shape != v0.shape or v.device != v0.device for v in volumes):
        raise ValueError("wta4 takes 2-4 direction volumes of one shape on one device")
    if v0.dim() != 4 or v0.shape[-1] < 3:
        raise ValueError(f"expected (B, H, W, D>=3) volumes, got {tuple(v0.shape)}")
    if v0.device.type == "cpu":
        return wta4_plain(volumes, uniqueness_ratio)
    if v0.dtype not in (torch.int16, torch.int32) or any(v.dtype != v0.dtype or not v.is_contiguous() for v in volumes):
        raise TypeError("the CUDA WTA kernel takes contiguous volumes of one type, int16 or int32")
    B, H, W, D = v0.shape
    maps, uok = _maps(v0)
    ptrs = [v.data_ptr() for v in volumes] + [None] * (4 - len(volumes))
    lib = _lib()
    err = lib.svt_sgm_wta(*ptrs, len(volumes), *(m.data_ptr() for m in maps), uok.data_ptr(),
                          B * H * W, D, uniqueness_ratio, v0.element_size(), _stream(v0))
    _build.check(lib, err, "svt_sgm_wta")
    wta4.launches += 1
    return (*maps, uok)


def wta_stats(S, uniqueness_ratio: int):
    """WTA stats of one aggregated (B, H, W, D) int32 volume: the six maps
    :func:`wta4` returns (the port of ``wta_stats_pallas``)."""
    if S.dim() != 4 or S.shape[-1] < 3:
        raise ValueError(f"expected a (B, H, W, D>=3) volume, got {tuple(S.shape)}")
    if S.device.type == "cpu":
        return wta_scan(S, S.shape[-1], uniqueness_ratio)
    if S.device.type != "cuda":
        raise ValueError(f"unsupported device {S.device}")
    if S.dtype != torch.int32 or not S.is_contiguous():
        raise TypeError("the CUDA WTA kernel takes a contiguous int32 volume")
    B, H, W, D = S.shape
    maps, uok = _maps(S)
    lib = _lib()
    err = lib.svt_sgm_wta_stats(S.data_ptr(), *(m.data_ptr() for m in maps), uok.data_ptr(), B * H * W, D,
                                uniqueness_ratio, _stream(S))
    _build.check(lib, err, "svt_sgm_wta_stats")
    wta_stats.launches += 1
    return (*maps, uok)


def aggregate_8(C, P1: int, P2: int, num_paths: int = 8, *, cost_bound: int):
    """(B, H, W, D) cost -> the int32 volume aggregated over ``num_paths``
    in {2, 3, 4, 8} directions: the port of ``aggregate_8_pallas`` (4 and 8
    paths) and of the scan ``_aggregate_8`` (2 and 3). On CUDA it runs the
    vertical and horizontal kernels, stored as :func:`storage_dtype` picks
    (``cost_bound`` bounds C), and sums their volumes into int32."""
    if num_paths not in (2, 3, 4, 8):
        raise ValueError(f"num_paths must be 2, 3, 4 or 8, got {num_paths}")
    C = _check_volume(C, P1, P2, cost_bound, 3 if num_paths >= 8 else 1)
    if C.device.type == "cpu":
        return _aggregate_8(C, P1, P2, num_paths)
    s_dn, s_up = vertical(C, P1, P2, num_paths >= 8, cost_bound)
    S = s_dn.to(torch.int32)
    S += s_up
    if num_paths >= 3:
        S += horizontal(C, P1, P2, False, cost_bound)
    if num_paths >= 4:
        S += horizontal(C, P1, P2, True, cost_bound)
    aggregate_8.launches += 1
    return S


def rl_wta_plan(D: int, dtype: torch.dtype) -> dict:
    """How :func:`horizontal_rl_wta` launches at D disparities stored in
    ``dtype`` (int16 or int32): the fields of ``_RL_PLAN_FIELDS``, the form by
    name ("ring": the lanes' words copied into a ring of columns in shared
    memory; "direct": D % VPL != 0 or 2 bytes a lane, VPL = D / 32 rounded
    up to a power of two; "wide": above 1024)."""
    nbytes = dtype.itemsize
    key = (D, nbytes)
    plan = _rl_plans.get(key)
    if plan is None:
        lib = _lib()
        out = (ctypes.c_longlong * len(_RL_PLAN_FIELDS))()
        _build.check(lib, lib.svt_sgm_rl_wta_plan(D, nbytes, out), "svt_sgm_rl_wta_plan")
        plan = dict(zip(_RL_PLAN_FIELDS, out))
        plan["form"] = _RL_FORMS[plan["form"]]
        _rl_plans[key] = plan
    return plan


def horizontal_rl_wta(C, s_dn, s_up, s_lr, P1: int, P2: int, uniqueness_ratio: int):
    """The R->L scan of the (B, H, W, D) cost fused with the WTA over the
    four directions (``s_dn``, ``s_up``, ``s_lr`` and the scan's own): the
    six maps :func:`wta4` returns, the R->L volume never stored. On CUDA one
    device launch by :func:`rl_wta_plan` (``horizontal_rl_wta.plan``: the
    last call's)."""
    vols = (s_dn, s_up, s_lr)
    if C.dim() != 4 or C.shape[-1] < 3 or any(v.shape != C.shape or v.device != C.device for v in vols):
        raise ValueError(f"expected a (B, H, W, D>=3) cost and three volumes of its shape on its device, got "
                         f"{tuple(C.shape)}, {[tuple(v.shape) for v in vols]}")
    if P1 < 0 or P2 < 0:
        raise ValueError("P1 and P2 must be >= 0")
    if C.device.type == "cpu":
        return horizontal_rl_wta_plain(C, s_dn, s_up, s_lr, P1, P2, uniqueness_ratio)
    if C.device.type != "cuda":
        raise ValueError(f"unsupported device {C.device}")
    if C.dtype not in (torch.int16, torch.int32) or any(t.dtype != C.dtype or not t.is_contiguous()
                                                         for t in (C, *vols)):
        raise TypeError("the fused R->L WTA kernel takes contiguous tensors of one type, int16 or int32")
    if any(t.data_ptr() % 16 for t in (C, *vols)):
        raise TypeError("the fused R->L WTA kernel takes tensors that start on 16 bytes")
    B, H, W, D = C.shape
    maps, uok = _maps(C)
    lib = _lib()
    # Above 1024 disparities the scan's carry goes through a pair of rows of scratch.
    nbytes = lib.svt_sgm_rl_wta_scratch_bytes(B, H, D, C.element_size())
    Lbuf = torch.empty(nbytes, dtype=torch.uint8, device=C.device) if nbytes else None
    err = lib.svt_sgm_horizontal_rl_wta(C.data_ptr(), *(v.data_ptr() for v in vols),
                                        *(m.data_ptr() for m in maps), uok.data_ptr(), B, H, W, D, P1, P2,
                                        uniqueness_ratio, C.element_size(),
                                        None if Lbuf is None else Lbuf.data_ptr(), _stream(C))
    _build.check(lib, err, "svt_sgm_horizontal_rl_wta")
    horizontal_rl_wta.launches += 1
    horizontal_rl_wta.plan = rl_wta_plan(D, C.dtype)
    return (*maps, uok)


def sgm_reduce(C, P1: int, P2: int, uniqueness_ratio: int, *, cost_bound: int, num_paths: int = 8):
    """Aggregation over ``num_paths`` in {2, 3, 4, 8} + WTA, the port of
    ``sgm_reduce_pallas`` (which took only 4 and 8): six (B, H, W) maps as
    :func:`wta4` returns them. ``cost_bound`` bounds the values of ``C``
    (the CUDA kernels store the volumes in the type it needs). With
    ``_FUSED_RL_WTA`` set, 4 and 8 paths end in :func:`horizontal_rl_wta`."""
    if num_paths not in (2, 3, 4, 8):
        raise ValueError(f"num_paths must be 2, 3, 4 or 8, got {num_paths}")
    C = _check_volume(C, P1, P2, cost_bound, 3 if num_paths >= 8 else 1)
    vols = list(vertical(C, P1, P2, num_paths >= 8, cost_bound))
    if num_paths >= 3:
        vols.append(horizontal(C, P1, P2, False, cost_bound))
    if num_paths >= 4:
        if _FUSED_RL_WTA:
            return horizontal_rl_wta(C, *vols, P1, P2, uniqueness_ratio)
        vols.append(horizontal(C, P1, P2, True, cost_bound))
    return wta4(vols, uniqueness_ratio)


vertical.launches = 0
vertical.launches_by_form = dict.fromkeys(FORMS, 0)
vertical.device_launches = 0
vertical.plan = None
horizontal.launches = 0
wta4.launches = 0
wta_stats.launches = 0
aggregate_8.launches = 0
horizontal_rl_wta.launches = 0
horizontal_rl_wta.plan = None
