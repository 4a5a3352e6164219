"""Hierarchical (coarse-to-fine) SGBM: a coarse prior, then a banded search.

Port of ``stereo_vision_tpu/stereo/hier.py``: the batched form and the
per-frame entry :func:`stereo_sgbm_hier`. A coarse pass on a
``coarse_factor``-downsampled pair with the full disparity range (the
banded core at s = 0, K = D/f, in the batch; the exact matcher per frame;
every ``coarse_stride``-th disparity with a strided search), optional mid
levels that refine the
prior with their own band, shift maps s(y, x) built from the prior, a
full-resolution search over ``band`` lanes around s (:mod:`.banded_cuda`,
whose kernels run for CUDA tensors), then assembly with the full-range
LR check (:mod:`.lr_cuda`) and the speckle filter (:mod:`.speckle_cuda`).
The image pyramid is :func:`.banded_cuda.downsample_pyramid` (both images,
the coarse level and every mid level in one launch).

The TPU path's kernels all have CUDA counterparts here: the banded core
(with the diagonal carries at 8 paths), the box downsample (the JAX
package's ``_DS_PALLAS``) and the packed LR check (its
``lr_fail_pallas_packed``, which it runs on the TPU for the 4-stat levels;
the port runs it at every level that checks LR, 4- or 6-stat: it is
bit-identical to the shift-chain form the JAX package runs elsewhere).
The speckle filter runs the CUDA form of the JAX package's
``speckle_filter_pallas`` (the JAX path runs its XLA form, bit-identical).

Every frame of the batch runs through one set of kernel launches: the
TPU package's lane packing (P * band == 128), seam stacking and row
stacking are layout devices that are bit-identical to per-frame runs
(``tests/test_banded_pallas.py``), so the port runs the frames on the
grid. It keeps the JAX parameter checks (pack size, shift-map tile side)
so that the same configurations are accepted.

Exactness of the plain glue against the JAX package: the pyramid's box means
and ``_upsample_repeat`` are integer sums and ``repeat_interleave`` (the
JAX 0/1 matmuls are exact; no float32 matmul here, so no TF32 setting
touches them), and ``shift_map`` keeps the JAX float32 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_vision_tpu_torch.stereo.banded import _clamped
from stereo_vision_tpu_torch.stereo.banded_cuda import FUSED_BAND, banded_stats_pack, downsample_pyramid
from stereo_vision_tpu_torch.stereo.lr_cuda import lr_fail_packed
from stereo_vision_tpu_torch.stereo.postprocess import _nb
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm, subpixel_disp16
from stereo_vision_tpu_torch.stereo.speckle_cuda import speckle_filter


class MidLevel(NamedTuple):
    """One intermediate level of the prior pyramid (``hier.MidLevel``):
    its resolution factor vs full res, band, granularity, tile (in the
    previous level's pixels), margin, local window and SGM path count."""

    factor: int
    band: int
    granularity: int
    tile: int = 2
    margin: float = 2.5
    local_window: int = 1
    paths: int = 2


class HierParams(NamedTuple):
    """Coarse-to-fine configuration (``hier.HierParams``, same fields and
    defaults). ``coarse_stride > 1`` searches the coarse level at every
    coarse_stride-th disparity."""

    band: int = 32
    granularity: int = 16
    coarse_factor: int = 4
    tile: int = 2
    margin: float = 4.0
    local_window: int = 0
    coarse_uniqueness: int = 10
    coarse_lr: int = 1
    anchor_hi: bool = True
    coarse_fx: int | None = None
    coarse_stride: int = 1
    speckle_diameter: int | None = None
    coarse_paths: int = 4
    mid_factor: int | None = None
    mid_band: int = 16
    mid_granularity: int = 8
    mid_tile: int = 2
    mid_margin: float = 4.0
    mid_local_window: int = 1
    mid_paths: int = 4
    mid_levels: tuple = ()
    wide_margin: float = 0.0


# The JAX package's presets (hier.py:165-234): band 16 (8 frames a call),
# band 8 behind a 1/2-res mid level (16 frames) and band 4 behind the same
# two-level prior (32 frames).
HIER_FAST = HierParams(band=16, granularity=8, margin=4.0, tile=1, local_window=1, coarse_lr=-1,
                       speckle_diameter=8)
HIER8_FAST = HIER_FAST._replace(
    band=8, granularity=4, tile=2, margin=1.5,
    mid_factor=2, mid_band=8, mid_granularity=4, mid_tile=2,
    mid_margin=2.5, mid_local_window=1, mid_paths=2,
    speckle_diameter=4,
)
HIER4_FAST = HIER8_FAST._replace(band=4, granularity=2, margin=0.75, mid_margin=3.0)


def _upsample_repeat(s: torch.Tensor, f: int, fx: int | None = None) -> torch.Tensor:
    """Each value repeated f x fx (rows x columns), dtype kept."""
    fy, fx = f, f if fx is None else fx
    return s.repeat_interleave(fy, dim=-2).repeat_interleave(fx, dim=-1)


def _fill_invalid(disp: torch.Tensor, invalid_below: float, rounds: int = 12) -> torch.Tensor:
    """Fill invalid prior pixels from the min of valid 4-neighbours for
    ``rounds`` rounds (occluded regions belong to the background); what is
    left becomes 0. float32, (..., H, W)."""
    big = 1e9
    d = disp.to(torch.float32)
    for _ in range(rounds):
        valid = d >= invalid_below
        dv = torch.where(valid, d, big)
        m = torch.minimum(torch.minimum(_nb(dv, 0, big), _nb(dv, 1, big)),
                          torch.minimum(_nb(dv, 2, big), _nb(dv, 3, big)))
        d = torch.where(valid | (m >= big), d, m)
    return torch.where(d >= invalid_below, d, 0.0)


def _pool(a: torch.Tensor, r: int, op) -> torch.Tensor:
    """(2r+1)^2 min/max pool over the last two axes, replicate borders."""
    H, W = a.shape[-2:]
    out = a
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                out = op(out, a[..., _clamped(H, dy, a.device), :][..., _clamped(W, dx, a.device)])
    return out


def shift_map(coarse_disp: torch.Tensor, num_disparities: int, hp: HierParams,
              coarse_invalid_below: float = 0.0) -> torch.Tensor:
    """(..., Hc, Wc) prior disparity -> (..., Hc*f, Wc*fx) int32 shift map,
    values on the G grid in [0, D - band], constant on (f*tile x fx*tile)
    tiles; float32 arithmetic as in the reference."""
    D, B, G, f, t = num_disparities, hp.band, hp.granularity, hp.coarse_factor, hp.tile
    fx = hp.coarse_fx or f
    prior = _fill_invalid(coarse_disp, coarse_invalid_below) * fx
    lo = _pool(prior, hp.local_window, torch.minimum) - hp.margin
    hi = _pool(prior, hp.local_window, torch.maximum) + hp.margin

    Hc, Wc = prior.shape[-2:]
    Ht, Wt = Hc // t, Wc // t
    lead = prior.shape[:-2]
    lo_t = lo[..., : Ht * t, : Wt * t].reshape(*lead, Ht, t, Wt, t).amin(dim=(-3, -1))
    hi_t = hi[..., : Ht * t, : Wt * t].reshape(*lead, Ht, t, Wt, t).amax(dim=(-3, -1))

    s = torch.round((lo_t + hi_t - B) / 2.0)
    if hp.anchor_hi:
        anchor = hi_t + hp.margin - B
        if hp.wide_margin:
            anchor = torch.where((hi_t - lo_t) > float(B), anchor + hp.wide_margin, anchor)
        s = torch.maximum(s, anchor)
    s = torch.round(s / G) * G
    lo_ok = torch.floor(lo_t / G) * G
    hi_ok = torch.ceil((hi_t - B) / G) * G
    s = torch.where(hi_ok <= lo_ok, torch.minimum(torch.maximum(s, hi_ok), lo_ok), s)
    s = s.clamp(0.0, float(D - B)).to(torch.int32)
    return _upsample_repeat(s, f * t, fx * t)


def _edge_pad(a: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Replicate the last row/column of (..., h, w) out to (..., H, W)."""
    h, w = a.shape[-2:]
    if (h, w) == (H, W):
        return a
    rows = torch.arange(H, device=a.device).clamp(max=h - 1)
    cols = torch.arange(W, device=a.device).clamp(max=w - 1)
    return a[..., rows, :][..., cols]


def _assemble_disparity(stats, s_v, W: int, min_x: int, ndisp_full: int, band: int,
                        params: StereoSGBMParams, stride: int = 1) -> torch.Tensor:
    """Banded stats on columns x >= min_x -> (P, H, W) float32 disparity
    (pre-speckle, invalid -1): the reference's ``_assemble_disparity`` and
    its batched ``_assemble_disparity_pack`` in one. ``stats`` is (minS,
    best_k, sm, s0, sp, unique_ok) or the 4-stat (minS, best_k, sub16,
    unique_ok); ``s_v`` the shift map on the same columns (None: zero, the
    coarse pass). ``stride > 1`` (the strided coarse search): lane k is
    disparity stride * k, and the lane-unit parabola is scaled back. The LR
    check runs over the full ``ndisp_full`` range on absolute values
    (:func:`.lr_cuda.lr_fail_packed`, which needs ``min_x == ndisp_full``)."""
    if len(stats) == 4:
        minS, k, sub16, unique_ok = stats
    else:
        minS, k, sm, s0, sp, unique_ok = stats
        sub16 = subpixel_disp16(k, sm, s0, sp, band)
    P, H = minS.shape[:2]
    full = torch.full((P, H, W), -1.0, dtype=torch.float32, device=minS.device)
    if minS.shape[-1] == 0:  # no column with the full range: all invalid, no LR check to run
        return full
    if s_v is None:
        best_abs, d16 = stride * k, stride * sub16
    elif stride != 1:
        raise ValueError("a strided search is coarse-only (s == 0)")
    else:
        best_abs, d16 = k + s_v, sub16 + 16 * s_v
    disp = d16.to(torch.float32) / 16.0
    valid = unique_ok
    if params.disp12_max_diff >= 0:
        valid = valid & ~lr_fail_packed(minS * 2048 + best_abs, d16, W=W, ndisp=ndisp_full,
                                        max_diff=params.disp12_max_diff)
    full[..., min_x:] = torch.where(valid, disp, -1.0)
    return full


# A/B toggle, as the reference's ``hier._FUSED_STATS`` (off there: it lost a
# TPU A/B): the full level of an 8-frame band-16 batch reduces with the
# fused WTA kernel (:func:`.banded_cuda.banded_wta_fused`), which emits the
# LR check's pack and d16 + 32768 * unique_ok in place of the 6-stat maps and
# the plain subpixel and pack glue. Bit-identical either way.
_FUSED_STATS = False


def _assemble_fused(pack, du, W: int, min_x: int, params: StereoSGBMParams) -> torch.Tensor:
    """The fused WTA's (pack, du) maps on columns x >= min_x -> (P, H, W)
    float32 disparity (pre-speckle, invalid -1); equal to
    :func:`_assemble_disparity` on the same core."""
    P, H = pack.shape[:2]
    full = torch.full((P, H, W), -1.0, dtype=torch.float32, device=pack.device)
    if pack.shape[-1] == 0:  # no column with the full range: all invalid, no LR check to run
        return full
    d16 = du & 32767
    valid = du >= 32768  # the unique_ok bit
    if params.disp12_max_diff >= 0:
        valid = valid & ~lr_fail_packed(pack, d16, W=W, ndisp=min_x, max_diff=params.disp12_max_diff)
    full[..., min_x:] = torch.where(valid, d16.to(torch.float32) / 16.0, -1.0)
    return full


def _wta_sub(band: int) -> bool:
    """Bands <= 8 take the 4-stat WTA (subpixel finished in the kernel),
    wider bands the 6-stat one, as the reference's default."""
    return band <= 8


def _coarse_params(params: StereoSGBMParams, D: int, fx: int, hp: HierParams) -> StereoSGBMParams:
    return params._replace(
        num_disparities=D // fx,
        uniqueness_ratio=hp.coarse_uniqueness,
        disp12_max_diff=hp.coarse_lr,
        speckle_window_size=0,
        num_paths=hp.coarse_paths,
    )


def _splice_coarse(disp_m, best_k, disp_c, s_m, Bm: int, Dm: int, fc: int) -> torch.Tensor:
    """Mid disparity (P, Hm, Wm) with band-clamp artifacts replaced by the
    upsampled coarse value: where the mid winner sits at a band edge
    (k <= 1 or k >= Bm - 2, on the valid columns), is invalid, or the
    coarse value lies outside the mid band [s_m, s_m + Bm - 1]."""
    Hm, Wm = disp_m.shape[-2:]
    edge = (best_k <= 1) | (best_k >= Bm - 2)
    edge_full = torch.zeros(disp_m.shape, dtype=torch.bool, device=disp_m.device)
    edge_full[..., Dm:] = edge
    cu = _edge_pad(_upsample_repeat(disp_c, fc), Hm, Wm)
    cu = torch.where(cu >= 0, cu * fc, -1.0)
    covered = (cu < 0) | ((cu >= s_m) & (cu <= s_m + (Bm - 1)))
    good_mid = (disp_m >= 0) & ~edge_full & covered
    return torch.where(good_mid, disp_m, cu)


def _prior_levels(hp: HierParams) -> tuple[MidLevel, ...]:
    """The mid levels, coarse to fine: ``mid_levels`` when set, else the
    single-level ``mid_*`` shorthand, else none."""
    if hp.mid_levels:
        return tuple(hp.mid_levels)
    if hp.mid_factor is not None:
        return (MidLevel(hp.mid_factor, hp.mid_band, hp.mid_granularity, hp.mid_tile,
                         hp.mid_margin, hp.mid_local_window, hp.mid_paths),)
    return ()


def _level_shift_params(hp: HierParams, lv: MidLevel, prev_f: int) -> HierParams:
    """shift_map parameters of level ``lv``, whose prior comes from the
    previous level at ``prev_f // lv.factor`` times its resolution."""
    if hp.coarse_fx is not None:
        raise ValueError("the prior pyramid assumes square coarse factors")
    if prev_f % lv.factor or prev_f <= lv.factor:
        raise ValueError(f"level factor {lv.factor} must divide and be below {prev_f}")
    return HierParams(
        band=lv.band, granularity=lv.granularity, coarse_factor=prev_f // lv.factor,
        tile=lv.tile, margin=lv.margin, local_window=lv.local_window,
        anchor_hi=hp.anchor_hi, wide_margin=hp.wide_margin,
    )


def _as_frames(a: torch.Tensor) -> torch.Tensor:
    if a.dim() != 3:
        raise ValueError(f"expected (P, H, W) frames, got {tuple(a.shape)}")
    return a.to(torch.int32).contiguous()


def _coarse_pass(lc, rc, params: StereoSGBMParams, hp: HierParams, exact: bool) -> torch.Tensor:
    """The coarse disparity of the downsampled (P, Hc, Wc) pair, full range
    Dc = D / fx: the exact matcher (``exact``, the per-frame entry's) or the
    banded core at s = 0 with Dc / coarse_stride lanes, lane k being
    disparity coarse_stride * k. The two agree where both run (stride 1)."""
    D, f = params.num_disparities, hp.coarse_factor
    fx = hp.coarse_fx or f
    cp = _coarse_params(params, D, fx, hp)
    if exact and hp.coarse_stride == 1:
        return stereo_sgbm(lc, rc, cp)
    Dc, stride = D // fx, hp.coarse_stride
    s0 = torch.zeros(lc.shape, dtype=torch.int32, device=lc.device)
    stats = banded_stats_pack(lc, rc, s0, cp, Dc // stride, hp.granularity, min_x=Dc, stride=stride, sub=True)
    return _assemble_disparity(stats, None, lc.shape[-1], Dc, Dc, Dc // stride, cp, stride=stride)


def _prior(left, right, params: StereoSGBMParams, hp: HierParams, exact_coarse: bool):
    """The coarse pass and the mid levels of (P, H, W) int32 frames:
    (disp_c, prior, prior_hp), see :func:`hier_batch_prior`."""
    D = params.num_disparities
    f = hp.coarse_factor
    fx = hp.coarse_fx or f

    levels = _prior_levels(hp)
    level_hps = [_level_shift_params(hp, lv, prev) for lv, prev in zip(levels, (f, *(lv.factor for lv in levels)))]
    # The pyramid: the coarse pair and every mid level's, one call.
    (lc, rc), *mids = downsample_pyramid(left, right, ((f, fx), *((lv.factor, lv.factor) for lv in levels)))

    # 1. Coarse prior on the downsampled pair.
    disp_c = _coarse_pass(lc, rc, params, hp, exact_coarse)

    # 1b. Mid levels: each refines the previous prior with its own band.
    prior, prev_f, prior_hp = disp_c, f, hp
    for lv, lv_hp, (lm, rm) in zip(levels, level_hps, mids):
        m = lv.factor
        Dm, Bm, Gm = D // m, lv.band, lv.granularity
        Hm, Wm = lm.shape[-2:]
        s_m = _edge_pad(shift_map(prior, Dm, lv_hp), Hm, Wm).contiguous()
        pm = _coarse_params(params, D, m, hp)._replace(num_paths=lv.paths)
        stats_m = banded_stats_pack(lm, rm, s_m, pm, Bm, Gm, min_x=Dm, sub=_wta_sub(Bm))
        disp_m = _assemble_disparity(stats_m, s_m[..., Dm:], Wm, Dm, Dm, Bm, pm)
        prior = _splice_coarse(disp_m, stats_m[1], prior, s_m, Bm, Dm, prev_f // m)
        prev_f = m
    if levels:
        prior_hp = hp._replace(coarse_factor=prev_f, coarse_fx=None)
    return disp_c, prior, prior_hp


def _full_level(left, right, params: StereoSGBMParams, hp: HierParams, prior, prior_hp,
                fused: bool) -> torch.Tensor:
    """Shift maps from the prior, the banded core over the full range's
    valid region (with ``fused``, through the fused WTA), assembly and the
    speckle filter: (P, H, W) float32 disparities."""
    D = params.num_disparities
    P, H, W = left.shape
    # Shift maps, edge-extended where H or W is not a multiple of the tile.
    s = _edge_pad(shift_map(prior, D, prior_hp), H, W).contiguous()
    if fused:
        pack, du = banded_stats_pack(left, right, s, params, hp.band, hp.granularity, min_x=D, fused=True)
        frames = _assemble_fused(pack, du, W, D, params)
    else:
        stats = banded_stats_pack(left, right, s, params, hp.band, hp.granularity, min_x=D, sub=_wta_sub(hp.band))
        frames = _assemble_disparity(stats, s[..., D:], W, D, D, hp.band, params)
    if params.speckle_window_size > 0:
        frames = speckle_filter(frames, max_diff=float(params.speckle_range),
                                max_speckle_size=params.speckle_window_size, invalid_value=-1.0,
                                max_diameter=hp.speckle_diameter)
    return frames


def hier_batch_prior(left, right, params: StereoSGBMParams, hp: HierParams):
    """The coarse pass and the mid levels of :func:`stereo_sgbm_hier_batch`.

    Returns (disp_c, prior, prior_hp): the coarse disparities, the prior
    the full-res shift maps are built from (== disp_c without mid levels),
    and the HierParams describing the prior's geometry."""
    left, right = _as_frames(left), _as_frames(right)
    D = params.num_disparities
    B, f = hp.band, hp.coarse_factor
    fx = hp.coarse_fx or f
    P = left.shape[0]
    if P * B != 128:
        raise ValueError(f"pack count {P} x band {B} must fill 128 lanes")
    # The reference's coarse pack rules: Kc = Dc / coarse_stride lanes, and
    # 128 / Kc frames a coarse pack dividing the batch.
    Dc, stride = D // fx, hp.coarse_stride
    if stride < 1 or Dc % stride or 128 % (Dc // stride) or P % (128 // (Dc // stride)):
        raise ValueError(f"coarse range {Dc} at stride {stride} does not pack {P} frames")
    return _prior(left, right, params, hp, exact_coarse=False)


def stereo_sgbm_hier_batch(left, right, params: StereoSGBMParams = StereoSGBMParams(),
                           hp: HierParams = HierParams()) -> torch.Tensor:
    """Hierarchical SGBM disparity of P frames, P = 128 // band.

    left, right: (P, H, W) rectified 8-bit frames. Returns (P, H, W)
    float32 disparities, invalid -1, valid region x >= num_disparities;
    each frame equals the JAX package's per-frame ``stereo_sgbm_hier``.
    CUDA tensors run the banded core's kernels, CPU tensors their plain
    forms. With ``_FUSED_STATS`` set, an 8-frame band-16 batch (HIER_FAST)
    takes the fused WTA at its full level, as the reference's gate."""
    if params.min_disparity != 0:
        raise ValueError("hier mode assumes min_disparity == 0")
    # The reference's tile-side rule (its reduce kernels realign carries on
    # 4-px or 8-aligned tiles); the port's per-step deltas need no tiles,
    # but it accepts the same configurations.
    levels = _prior_levels(hp)
    pf = levels[-1].factor if levels else hp.coarse_factor
    pfx = levels[-1].factor if levels else (hp.coarse_fx or hp.coarse_factor)
    for t_px in (pf * hp.tile, pfx * hp.tile):
        if not (t_px % 8 == 0 or t_px == 4):
            raise ValueError(f"unsupported shift tile {t_px}px (need 4 or a multiple of 8)")
    left, right = _as_frames(left), _as_frames(right)
    _, prior, prior_hp = hier_batch_prior(left, right, params, hp)
    fused = _FUSED_STATS and hp.band == FUSED_BAND and left.shape[0] == 8
    return _full_level(left, right, params, hp, prior, prior_hp, fused)


def _check_window_lanes(K: int, G: int, what: str) -> None:
    """The reference's per-frame banded core aligns a window's bands by
    concatenating a neighbour's lanes from G on with the centre's last K - G
    (stereo_vision_tpu/stereo/banded.py ``align_window``): where K < G < 2K
    that row has fewer than K lanes, and its ``jnp.where`` fails to
    broadcast. The per-frame entry refuses those bands before any launch."""
    if K < G < 2 * K:
        raise ValueError(f"{what} is {K} lanes at granularity {G}: the reference's window alignment takes no "
                         f"band of K lanes with K < G < 2K")


def stereo_sgbm_hier(left, right, params: StereoSGBMParams = StereoSGBMParams(),
                     hp: HierParams = HierParams()) -> torch.Tensor:
    """Hierarchical SGBM disparity of one (H, W) rectified 8-bit pair: the
    reference's per-frame entry, a drop-in for :func:`.sgbm.stereo_sgbm`
    ((H, W) float32, invalid -1, valid region x >= num_disparities).

    Its coarse pass is the exact matcher on the downsampled pair (with
    ``coarse_stride > 1`` the strided banded core at s = 0); the mid levels
    and the full level run the banded core on the one frame."""
    if params.min_disparity != 0:
        raise ValueError("hier mode assumes min_disparity == 0")
    D, B, G = params.num_disparities, hp.band, hp.granularity
    fx = hp.coarse_fx or hp.coarse_factor
    if D % (fx * 16) or B % 4 or (D - B) % G:
        raise ValueError(f"num_disparities {D} must be a multiple of {fx * 16}, band {B} of 4 and D - band of "
                         f"granularity {G}")
    if any(lv.band % 8 or D % lv.factor for lv in _prior_levels(hp)):
        raise ValueError("a mid level needs a band that is a multiple of 8 and a factor dividing num_disparities")
    if left.dim() != 2 or right.shape != left.shape:
        raise ValueError(f"expected one (H, W) pair, got {tuple(left.shape)} and {tuple(right.shape)}")
    bands = [(B, G, "the full level's band")] + [(lv.band, lv.granularity, "a mid level's band")
                                                  for lv in _prior_levels(hp)]
    if hp.coarse_stride > 1:
        bands.append(((D // fx) // hp.coarse_stride, G, "the strided coarse search's lane count"))
    for K, g, what in bands:
        _check_window_lanes(K, g, what)
    left, right = _as_frames(left[None]), _as_frames(right[None])
    _, prior, prior_hp = _prior(left, right, params, hp, exact_coarse=True)
    return _full_level(left, right, params, hp, prior, prior_hp, fused=False)[0]
