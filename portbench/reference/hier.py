"""Plain reference of the hierarchical (coarse-to-fine) SGBM matcher on rectified frames.

Frozen copy, at commit 32282d13a4194c9fbd48da53129198c48182e76c, of the batched path of
``stereo_vision_tpu_torch/stereo/hier.py`` (``stereo_sgbm_hier_batch``: the pyramid, the coarse pass at
s = 0, the mid levels with their splice, the shift maps, the full level, assembly with the packed LR
check, the speckle filter) and of the plain forms it runs on the CPU: ``stereo/banded.py`` (the banded
cost, alignment and scans), ``stereo/banded_cuda.py`` (``banded_wta_plain``, ``downsample_box_plain``)
and ``stereo/lr_cuda.py`` (``lr_fail_packed_plain``). Plain torch; nothing of the program is imported.
Every frame is computed alone (the program packs 128 // band frames a call; the result of a frame does
not depend on the others).
"""

from __future__ import annotations

import torch

from portbench.reference import common

# ------------------------------------------------------------ banded core


def lane_shift(a: torch.Tensor, d: int, fill=None) -> torch.Tensor:
    """out[..., k] = a[..., k + d]; ``fill=None`` replicates the band edge."""
    if d == 0:
        return a
    K = a.shape[-1]

    def pad(n, edge):
        if fill is None:
            return edge.expand(*a.shape[:-1], n)
        return torch.full((*a.shape[:-1], n), fill, dtype=a.dtype, device=a.device)

    if abs(d) >= K:
        return pad(K, a[..., -1:] if d > 0 else a[..., :1])
    if d > 0:
        return torch.cat([a[..., d:], pad(d, a[..., -1:])], dim=-1)
    return torch.cat([pad(-d, a[..., :1]), a[..., :d]], dim=-1)


def align_band(a: torch.Tensor, delta: torch.Tensor, G: int, *, diag: bool = False, fill=None) -> torch.Tensor:
    d = delta[..., None]
    out = a
    units = [-1, 1]
    if diag and 2 * G < a.shape[-1]:
        units += [-2, 2]
    for u in units:
        out = torch.where(d == u * G, lane_shift(a, u * G, fill), out)
    maxsup = max(units) * G
    if fill is None:
        out = torch.where(d > maxsup, lane_shift(a, maxsup, None), out)
        out = torch.where(d < -maxsup, lane_shift(a, -maxsup, None), out)
    else:
        out = torch.where(d.abs() > maxsup, torch.full_like(a, fill), out)
    return out


def align_window(a: torch.Tensor, delta: torch.Tensor, center: torch.Tensor, G: int) -> torch.Tensor:
    d = delta[..., None]
    K = a.shape[-1]
    if G >= K:
        up = dn = center
    else:
        up = torch.cat([a[..., G:], center[..., K - G:]], dim=-1)
        dn = torch.cat([center[..., :G], a[..., : K - G]], dim=-1)
    out = torch.where(d == G, up, torch.where(d == -G, dn, a))
    return torch.where(d.abs() > G, center, out)


def banded_pixel_cost(left, right, s, *, band: int, ndisp: int, ftzero: int, stride: int = 1) -> torch.Tensor:
    """(P, H, W, band) int16 per-pixel BT cost at disparity clamp(s + stride * k, 0, ndisp - 1)."""
    W = left.shape[-1]
    pad = ndisp - 1

    def padded(a):
        ap = torch.cat([a[..., :1].expand(*a.shape[:-1], pad), a], dim=-1)
        return (ap, *common.half_extrema(ap))

    chans = []
    for lft, rgt in ((common.xsobel_clipped(left, ftzero), common.xsobel_clipped(right, ftzero)),
                     (left.to(torch.int32), right.to(torch.int32))):
        chans.append((lft, *common.half_extrema(lft), *padded(rgt)))
    x = torch.arange(W, device=left.device)
    s = s.to(torch.int64)
    out = torch.empty((*left.shape, band), dtype=torch.int16, device=left.device)
    for k in range(band):
        idx = x - (s + stride * k).clamp(0, ndisp - 1) + pad
        cost = []
        for lv, u0, u1, v_p, v0_p, v1_p in chans:
            v, vv0, vv1 = (torch.gather(a, -1, idx) for a in (v_p, v0_p, v1_p))
            c0 = torch.maximum((lv - vv1).clamp(min=0), vv0 - lv)
            c1 = torch.maximum((v - u1).clamp(min=0), u0 - v)
            cost.append(torch.minimum(c0, c1))
        out[..., k] = cost[0] + (cost[1] >> 2)
    return out


def clamped(n: int, off: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) + off).clamp(0, n - 1)


def banded_cost_volume(left, right, s, *, band: int, G: int, ndisp: int, ftzero: int, block_size: int,
                       stride: int = 1) -> torch.Tensor:
    """(P, H, W, band) int32 windowed banded cost: neighbours' lanes aligned into p's band, rows then columns."""
    H, W = left.shape[-2:]
    pb = banded_pixel_cost(left, right, s, band=band, ndisp=ndisp, ftzero=ftzero, stride=stride).to(torch.int32)
    r = block_size // 2
    acc = None
    for dy in range(block_size):
        rows = clamped(H, dy - r, s.device)
        term = align_window(pb[:, rows], s - s[:, rows], pb, G)
        acc = term if acc is None else acc + term
    out = None
    for dx in range(block_size):
        cols = clamped(W, dx - r, s.device)
        term = align_window(acc[:, :, cols], s - s[:, :, cols], acc, G)
        out = term if out is None else out + term
    return out


def update_banded(c, L_aligned, P1: int, P2: int):
    minL = L_aligned.amin(dim=-1, keepdim=True)
    full_miss = minL >= common.BIG
    minL_eff = torch.where(full_miss, 0, minL)
    fill = torch.full_like(L_aligned[..., :1], common.BIG)
    Lm = torch.cat([fill, L_aligned[..., :-1]], dim=-1)
    Lp = torch.cat([L_aligned[..., 1:], fill], dim=-1)
    cand = torch.minimum(torch.minimum(L_aligned, minL_eff + P2), torch.minimum(Lm, Lp) + P1)
    return torch.where(full_miss, c, c + cand - minL_eff)


def row_delta(s, dx: int):
    prev = s[:, :-1]
    if dx == 1:
        prev = torch.cat([s[:, 1:, :1], prev[:, :, :-1]], dim=2)
    elif dx == -1:
        prev = torch.cat([prev[:, :, 1:], s[:, 1:, -1:]], dim=2)
    return torch.cat([torch.zeros_like(s[:, :1]), s[:, 1:] - prev], dim=1)


def scan_down(C, s, G: int, P1: int, P2: int, with_diagonals: bool):
    P, H, W, K = C.shape
    dv, dd, du = row_delta(s, 0), row_delta(s, 1), row_delta(s, -1)
    zero = torch.zeros((P, W, K), dtype=torch.int32, device=C.device)
    Lv = Ld = Lu = zero
    S = torch.empty_like(C)
    for y in range(H):
        c = C[:, y]
        Lv = update_banded(c, align_band(Lv, dv[:, y], G, fill=common.BIG), P1, P2)
        if with_diagonals:
            Ld = update_banded(c, align_band(common.shift_cols(Ld, 1), dd[:, y], G, diag=True, fill=common.BIG),
                               P1, P2)
            Lu = update_banded(c, align_band(common.shift_cols(Lu, -1), du[:, y], G, diag=True, fill=common.BIG),
                               P1, P2)
            S[:, y] = Lv + Ld + Lu
        else:
            S[:, y] = Lv
    return S


def horizontal(C, s, G: int, P1: int, P2: int, reverse: bool = False):
    if reverse:
        return horizontal(C.flip(2), s.flip(2), G, P1, P2).flip(2)
    P, H, W, K = C.shape
    dh = torch.cat([torch.zeros_like(s[:, :, :1]), s[:, :, 1:] - s[:, :, :-1]], dim=2)
    L = torch.zeros((P, H, K), dtype=torch.int32, device=C.device)
    S = torch.empty_like(C)
    for x in range(W):
        L = update_banded(C[:, :, x], align_band(L, dh[:, :, x], G, fill=common.BIG), P1, P2)
        S[:, :, x] = L
    return S


def banded_stats(left, right, s, p: dict, band: int, G: int, min_x: int, stride: int = 1, sub: bool = False):
    """Banded cost + aggregation over p's num_paths + WTA on columns x >= min_x: (minS, best_k, sm, s0,
    sp, unique_ok), or with ``sub`` (minS, best_k, sub16, unique_ok)."""
    C = banded_cost_volume(left, right, s, band=band, G=G, ndisp=p["num_disparities"], ftzero=p["ftzero"],
                           block_size=p["block_size"], stride=stride)[:, :, min_x:]
    sv = s[:, :, min_x:].to(torch.int32)
    P1, P2, n = p["P1"], p["P2"], p["num_paths"]
    V = scan_down(torch.cat([C, C.flip(1)]), torch.cat([sv, sv.flip(1)]), G, P1, P2, n >= 8)
    S = V[:C.shape[0]] + V[C.shape[0]:].flip(1)
    del V
    if n >= 3:
        S = S + horizontal(C, sv, G, P1, P2)
    if n in (4, 8):
        S = S + horizontal(C, sv, G, P1, P2, reverse=True)
    minS, best, sm, s0, sp, uok = common.wta_scan(S, band, p["uniqueness_ratio"])
    if sub:
        return minS, best, common.subpixel_disp16(best, sm, s0, sp, band), uok
    return minS, best, sm, s0, sp, uok


# ------------------------------------------------------------------- glue


def downsample_box(img: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Box mean, an exact integer sum divided in float32, rounded half to even."""
    H, W = img.shape[-2:]
    Hc, Wc = H // fy, W // fx
    x = img[..., : Hc * fy, : Wc * fx].to(torch.int32)
    u = x.reshape(*x.shape[:-2], Hc, fy, Wc, fx).sum(dim=(-3, -1), dtype=torch.int32)
    return torch.round(u.to(torch.float32) / (fy * fx)).to(torch.int32)


def upsample_repeat(s: torch.Tensor, f: int, fx: int | None = None) -> torch.Tensor:
    return s.repeat_interleave(f, dim=-2).repeat_interleave(f if fx is None else fx, dim=-1)


def fill_invalid(disp: torch.Tensor, invalid_below: float, rounds: int = 12) -> torch.Tensor:
    big = 1e9
    d = disp.to(torch.float32)
    for _ in range(rounds):
        valid = d >= invalid_below
        dv = torch.where(valid, d, big)
        m = torch.minimum(torch.minimum(common.nb(dv, 0, big), common.nb(dv, 1, big)),
                          torch.minimum(common.nb(dv, 2, big), common.nb(dv, 3, big)))
        d = torch.where(valid | (m >= big), d, m)
    return torch.where(d >= invalid_below, d, 0.0)


def pool(a: torch.Tensor, r: int, op) -> torch.Tensor:
    H, W = a.shape[-2:]
    out = a
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy or dx:
                out = op(out, a[..., clamped(H, dy, a.device), :][..., clamped(W, dx, a.device)])
    return out


def shift_map(coarse_disp: torch.Tensor, D: int, sp: dict) -> torch.Tensor:
    """Prior disparity -> int32 shift map on the G grid in [0, D - band], constant on tiles; float32."""
    B, G, f, t = sp["band"], sp["granularity"], sp["coarse_factor"], sp["tile"]
    fx = sp.get("coarse_fx") or f
    prior = fill_invalid(coarse_disp, 0.0) * fx
    lo = pool(prior, sp["local_window"], torch.minimum) - sp["margin"]
    hi = pool(prior, sp["local_window"], torch.maximum) + sp["margin"]
    Hc, Wc = prior.shape[-2:]
    Ht, Wt = Hc // t, Wc // t
    lead = prior.shape[:-2]
    lo_t = lo[..., : Ht * t, : Wt * t].reshape(*lead, Ht, t, Wt, t).amin(dim=(-3, -1))
    hi_t = hi[..., : Ht * t, : Wt * t].reshape(*lead, Ht, t, Wt, t).amax(dim=(-3, -1))
    s = torch.round((lo_t + hi_t - B) / 2.0)
    if sp["anchor_hi"]:
        anchor = hi_t + sp["margin"] - B
        if sp["wide_margin"]:
            anchor = torch.where((hi_t - lo_t) > float(B), anchor + sp["wide_margin"], anchor)
        s = torch.maximum(s, anchor)
    s = torch.round(s / G) * G
    lo_ok = torch.floor(lo_t / G) * G
    hi_ok = torch.ceil((hi_t - B) / G) * G
    s = torch.where(hi_ok <= lo_ok, torch.minimum(torch.maximum(s, hi_ok), lo_ok), s)
    s = s.clamp(0.0, float(D - B)).to(torch.int32)
    return upsample_repeat(s, f * t, fx * t)


def edge_pad(a: torch.Tensor, H: int, W: int) -> torch.Tensor:
    h, w = a.shape[-2:]
    if (h, w) == (H, W):
        return a
    rows = torch.arange(H, device=a.device).clamp(max=h - 1)
    cols = torch.arange(W, device=a.device).clamp(max=w - 1)
    return a[..., rows, :][..., cols]


def lr_fail_packed(pack, d16, *, W: int, ndisp: int, max_diff: int) -> torch.Tensor:
    return common.lr_fail(pack >> 11, pack & 2047, d16.to(torch.float32) / 16.0, W=W, min_x=ndisp, ndisp=ndisp,
                          mindisp=0, max_diff=max_diff)


def assemble(stats, s_v, W: int, min_x: int, ndisp_full: int, band: int, p: dict, fdt, stride: int = 1):
    """Banded stats on columns x >= min_x -> (P, H, W) disparity, pre-speckle, invalid -1."""
    if len(stats) == 4:
        minS, k, sub16, unique_ok = stats
    else:
        minS, k, sm, s0, sp, unique_ok = stats
        sub16 = common.subpixel_disp16(k, sm, s0, sp, band)
    P, H = minS.shape[:2]
    full = torch.full((P, H, W), -1.0, dtype=fdt, device=minS.device)
    if minS.shape[-1] == 0:
        return full
    if s_v is None:
        best_abs, d16 = stride * k, stride * sub16
    else:
        best_abs, d16 = k + s_v, sub16 + 16 * s_v
    disp = d16.to(fdt) / 16.0
    valid = unique_ok
    if p["disp12_max_diff"] >= 0:
        valid = valid & ~lr_fail_packed(minS * 2048 + best_abs, d16, W=W, ndisp=ndisp_full,
                                        max_diff=p["disp12_max_diff"])
    full[..., min_x:] = torch.where(valid, disp, torch.as_tensor(-1.0, dtype=fdt, device=disp.device))
    return full


def splice(disp_m, best_k, disp_c, s_m, Bm: int, Dm: int, fc: int) -> torch.Tensor:
    edge = (best_k <= 1) | (best_k >= Bm - 2)
    edge_full = torch.zeros(disp_m.shape, dtype=torch.bool, device=disp_m.device)
    edge_full[..., Dm:] = edge
    Hm, Wm = disp_m.shape[-2:]
    cu = edge_pad(upsample_repeat(disp_c, fc), Hm, Wm)
    cu = torch.where(cu >= 0, cu * fc, -1.0)
    covered = (cu < 0) | ((cu >= s_m) & (cu <= s_m + (Bm - 1)))
    good_mid = (disp_m >= 0) & ~edge_full & covered
    return torch.where(good_mid, disp_m, cu)


def level_params(p: dict, D: int, factor: int, hp: dict, paths: int) -> dict:
    """A coarser level's settings: range D / factor, the hier uniqueness and LR, no speckle."""
    return {**p, "num_disparities": D // factor, "uniqueness_ratio": hp["coarse_uniqueness"],
            "disp12_max_diff": hp["coarse_lr"], "speckle_window_size": 0, "num_paths": paths}


def mid_levels(hp: dict) -> list[dict]:
    if hp["mid_levels"]:
        return [dict(zip(("factor", "band", "granularity", "tile", "margin", "local_window", "paths"), lv))
                for lv in hp["mid_levels"]]
    if hp["mid_factor"] is not None:
        return [dict(factor=hp["mid_factor"], band=hp["mid_band"], granularity=hp["mid_granularity"],
                     tile=hp["mid_tile"], margin=hp["mid_margin"], local_window=hp["mid_local_window"],
                     paths=hp["mid_paths"])]
    return []


def disparity(left: torch.Tensor, right: torch.Tensor, p: dict, hp: dict, fdt=torch.float32) -> torch.Tensor:
    """(P, H, W) int32 rectified frames -> (P, H, W) disparity in ``fdt``, invalid -1; ``p`` the StereoSGBM
    settings (P1, P2, ftzero worked out), ``hp`` the hierarchy's."""
    D = p["num_disparities"]
    P, H, W = left.shape
    f = hp["coarse_factor"]
    fx = hp["coarse_fx"] or f
    levels = mid_levels(hp)
    lc, rc = downsample_box(left, f, fx), downsample_box(right, f, fx)
    # 1. the coarse pass: the banded core at s = 0 over the full coarse range
    Dc, stride = D // fx, hp["coarse_stride"]
    cp = level_params(p, D, fx, hp, hp["coarse_paths"])
    s0 = torch.zeros(lc.shape, dtype=torch.int32, device=lc.device)
    stats = banded_stats(lc, rc, s0, cp, Dc // stride, hp["granularity"], min_x=Dc, stride=stride, sub=True)
    prior = assemble(stats, None, lc.shape[-1], Dc, Dc, Dc // stride, cp, torch.float32, stride=stride)
    # 2. the mid levels, each refining the previous prior with its own band
    prev_f = f
    for lv in levels:
        m = lv["factor"]
        lm, rm = downsample_box(left, m, m), downsample_box(right, m, m)
        Dm, Bm, Gm = D // m, lv["band"], lv["granularity"]
        Hm, Wm = lm.shape[-2:]
        sp = dict(band=Bm, granularity=Gm, coarse_factor=prev_f // m, coarse_fx=None, tile=lv["tile"],
                  margin=lv["margin"], local_window=lv["local_window"], anchor_hi=hp["anchor_hi"],
                  wide_margin=hp["wide_margin"])
        s_m = edge_pad(shift_map(prior, Dm, sp), Hm, Wm).contiguous()
        pm = level_params(p, D, m, hp, lv["paths"])
        stats_m = banded_stats(lm, rm, s_m, pm, Bm, Gm, min_x=Dm, sub=Bm <= 8)
        disp_m = assemble(stats_m, s_m[..., Dm:], Wm, Dm, Dm, Bm, pm, torch.float32)
        prior = splice(disp_m, stats_m[1], prior, s_m, Bm, Dm, prev_f // m)
        prev_f = m
    # 3. the full level around the prior's shift maps
    sp = dict(band=hp["band"], granularity=hp["granularity"], coarse_factor=prev_f,
              coarse_fx=None if levels else hp["coarse_fx"], tile=hp["tile"], margin=hp["margin"],
              local_window=hp["local_window"], anchor_hi=hp["anchor_hi"], wide_margin=hp["wide_margin"])
    s = edge_pad(shift_map(prior, D, sp), H, W).contiguous()
    stats = banded_stats(left, right, s, p, hp["band"], hp["granularity"], min_x=D, sub=hp["band"] <= 8)
    frames = assemble(stats, s[..., D:], W, D, D, hp["band"], p, fdt)
    if p["speckle_window_size"] > 0:
        frames = common.speckle_filter(frames, float(p["speckle_range"]), p["speckle_window_size"], -1.0,
                                       max_diameter=hp["speckle_diameter"])
    return frames
