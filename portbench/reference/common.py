"""Plain stages shared by both matchers' references: remap, cost, SGM scans, WTA, LR, speckle, 3D, stats.

Frozen copy of the port's plain forms at commit 32282d13a4194c9fbd48da53129198c48182e76c:
``stereo_vision_tpu_torch/ops/remap.py`` (remap_bilinear), ``stereo/cost_cuda.py`` (_xsobel_clipped,
_half_extrema, _bt_channel_cost, _box_filter_same, compute_pixel_cost), ``stereo/sgm_cuda.py`` (the scans,
wta_scan), ``stereo/sgbm.py`` (subpixel_disp16, lr_fail), ``stereo/postprocess.py`` (speckle_filter),
``stereo/depth.py`` (reproject_disparity_to_3d) and ``parallel/streaming.py`` (_frame_stats).

Plain torch on any device; nothing of the program is imported. ``fdt`` is the type of every stage the
configuration states in float32 (remap, the float disparity, the speckle filter's compare, reprojection,
the stats): float32 is the reference, bfloat16 the lower-precision control.
"""

from __future__ import annotations

import torch

BIG = 1 << 29  # an out-of-range d +- 1 neighbour: far above any reachable L
LANE_FILL = -(1 << 31)  # what the reference's take_along_axis reads outside [-D, D)
OFFS = ((1, 0), (-1, 0), (0, 1), (0, -1))
OPP = (1, 0, 3, 2)


# ------------------------------------------------------------------ remap


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor, fdt=torch.float32) -> torch.Tensor:
    """(..., H, W) images + (Ho, Wo) source coordinates -> (..., Ho, Wo) bilinear samples; taps outside read 0."""
    H, W = img.shape[-2:]
    map_x, map_y = map_x.to(fdt), map_y.to(fdt)
    imgf = img.to(fdt).reshape(*img.shape[:-2], H * W)
    x0, y0 = torch.floor(map_x), torch.floor(map_y)
    fx, fy = map_x - x0, map_y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)
        v = imgf[..., flat].reshape(*img.shape[:-2], *map_x.shape)
        return torch.where(valid, v, torch.zeros((), dtype=fdt, device=v.device))

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
            + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)


# ------------------------------------------------------------------- cost


def window_bound(block_size: int, ftzero: int) -> int:
    return block_size * block_size * (2 * ftzero + 63)


def xsobel_clipped(img: torch.Tensor, ftzero: int) -> torch.Tensor:
    """SGBM's row Sobel: clip(dx, -ftzero, ftzero) + ftzero; columns 0 and W-1 are ftzero."""
    img = img.to(torch.int32)
    up = torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2)
    down = torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)

    def dx(a):
        return torch.cat([a[..., 1:], a[..., -1:]], dim=-1) - torch.cat([a[..., :1], a[..., :-1]], dim=-1)

    v = (2 * dx(img) + dx(up) + dx(down)).clamp(-ftzero, ftzero) + ftzero
    v[..., 0] = ftzero
    v[..., -1] = ftzero
    return v


def half_extrema(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Birchfield-Tomasi half-sample extrema along the last axis (edges replicated)."""
    left = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    right = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    vl = torch.div(a + left, 2, rounding_mode="floor")
    vr = torch.div(a + right, 2, rounding_mode="floor")
    return torch.minimum(torch.minimum(vl, vr), a), torch.maximum(torch.maximum(vl, vr), a)


def bt_channel_cost(p1row: torch.Tensor, p2row: torch.Tensor, ndisp: int, mindisp: int) -> torch.Tensor:
    """(..., H, W, D) int16 BT cost of left[x] against right[x - max(d + mindisp, 0)], the right row
    edge-padded on the left before its half-extrema are taken."""
    W = p1row.shape[-1]
    u0, u1 = half_extrema(p1row)
    maxshift = mindisp + ndisp - 1
    v_p = torch.cat([p2row[..., :1].expand(*p2row.shape[:-1], maxshift), p2row], dim=-1)
    v0_p, v1_p = half_extrema(v_p)
    out = torch.empty((*p1row.shape, ndisp), dtype=torch.int16, device=p1row.device)
    for d in range(ndisp):
        off = maxshift - max(mindisp + d, 0)
        v, vv0, vv1 = (a[..., off: off + W] for a in (v_p, v0_p, v1_p))
        c0 = torch.maximum((p1row - vv1).clamp(min=0), vv0 - p1row)
        c1 = torch.maximum((v - u1).clamp(min=0), u0 - v)
        out[..., d] = torch.minimum(c0, c1)
    return out


def box_filter_same(x: torch.Tensor, bs: int) -> torch.Tensor:
    """bs x bs box sum over axes (-3, -2) of (..., H, W, D), replicate-padded, in the input dtype."""
    r = bs // 2
    H, W = x.shape[-3], x.shape[-2]
    xp = torch.cat([x[..., :1, :, :]] * r + [x] + [x[..., -1:, :, :]] * r, dim=-3)
    y = xp[..., 0:H, :, :].clone()
    for k in range(1, bs):
        y += xp[..., k: k + H, :, :]
    yp = torch.cat([y[..., :1, :]] * r + [y] + [y[..., -1:, :]] * r, dim=-2)
    out = yp[..., 0:W, :].clone()
    for k in range(1, bs):
        out += yp[..., k: k + W, :]
    return out


def cost_volume(left, right, *, ndisp: int, mindisp: int, block_size: int, ftzero: int, x_offset: int):
    """(B, H, W - x_offset, D) windowed cost: sobel BT + (raw BT >> 2), box-summed over the full width."""
    pix = bt_channel_cost(xsobel_clipped(left, ftzero), xsobel_clipped(right, ftzero), ndisp, mindisp)
    pix = pix + (bt_channel_cost(left.to(torch.int32), right.to(torch.int32), ndisp, mindisp) >> 2)
    if block_size > 11:  # bs^2 * 93 would overflow int16
        pix = pix.to(torch.int32)
    return box_filter_same(pix, block_size)[..., x_offset:, :].contiguous()


# ------------------------------------------------------------------ scans


def sgm_update(c, L, minL, P1: int, P2: int):
    """L' = c + min(L, L(d-1)+P1, L(d+1)+P1, minL+P2) - minL, and its minimum."""
    big = torch.full_like(L[..., :1], BIG)
    Lm = torch.cat([big, L[..., :-1]], dim=-1)
    Lp = torch.cat([L[..., 1:], big], dim=-1)
    cand = torch.minimum(torch.minimum(L, minL + P2), torch.minimum(Lm, Lp) + P1)
    Lnew = c + cand - minL
    return Lnew, Lnew.amin(dim=-1, keepdim=True)


def shift_cols(a, direction: int):
    """Shift along the column axis (-2) of (..., W, D), zero fill."""
    z = torch.zeros_like(a[..., :1, :])
    if direction > 0:
        return torch.cat([z, a[..., :-1, :]], dim=-2)
    return torch.cat([a[..., 1:, :], z], dim=-2)


def aggregate_down(C, P1: int, P2: int, with_diagonals: bool):
    N, H, W, D = C.shape
    zero = torch.zeros((N, W, D), dtype=C.dtype, device=C.device)
    zmin = torch.zeros((N, W, 1), dtype=C.dtype, device=C.device)
    (Lv, mv), (Ld, md), (Lu, mu) = (zero, zmin), (zero, zmin), (zero, zmin)
    S = torch.empty_like(C)
    for y in range(H):
        c = C[:, y]
        Lv, mv = sgm_update(c, Lv, mv, P1, P2)
        if with_diagonals:
            Ld, md = sgm_update(c, shift_cols(Ld, 1), shift_cols(md, 1), P1, P2)
            Lu, mu = sgm_update(c, shift_cols(Lu, -1), shift_cols(mu, -1), P1, P2)
            S[:, y] = Lv + Ld + Lu
        else:
            S[:, y] = Lv
    return S


def aggregate_horiz(C, P1: int, P2: int):
    N, H, W, D = C.shape
    L = torch.zeros((N, H, D), dtype=C.dtype, device=C.device)
    m = torch.zeros((N, H, 1), dtype=C.dtype, device=C.device)
    S = torch.empty_like(C)
    for x in range(W):
        L, m = sgm_update(C[:, :, x], L, m, P1, P2)
        S[:, :, x] = L
    return S


def aggregate(C, P1: int, P2: int, num_paths: int):
    """Aggregated int32 volume over 8, 4, 3 or 2 directions."""
    C = C.to(torch.int32)
    B = C.shape[0]
    V = aggregate_down(torch.cat([C, C.flip(-3)]), P1, P2, num_paths >= 8)
    S = V[:B] + V[B:].flip(-3)
    del V
    if num_paths >= 3:
        S = S + aggregate_horiz(C, P1, P2)
    if num_paths >= 4:
        S = S + aggregate_horiz(C.flip(-2), P1, P2).flip(-2)
    return S


def take_lane(S, i):
    D = S.shape[-1]
    j = torch.where(i < 0, i + D, i)
    inside = (j >= 0) & (j < D)
    v = torch.gather(S, -1, j.clamp(0, D - 1)[..., None])[..., 0]
    return torch.where(inside, v, torch.full_like(v, LANE_FILL))


def wta_scan(S, ndisp: int, uniqueness_ratio: int):
    """(minS, best, sm, s0, sp, unique_ok) of an aggregated (..., D) volume; ties go to the smallest d."""
    minS, best = S.min(dim=-1)
    if uniqueness_ratio > 0:
        ds = torch.arange(ndisp, device=S.device)
        offender = (minS[..., None] * (100 + uniqueness_ratio) > S * 100) & ((ds - best[..., None]).abs() > 1)
        unique_ok = ~offender.any(dim=-1)
    else:
        unique_ok = torch.ones_like(best, dtype=torch.bool)
    d0 = best.clamp(1, ndisp - 2)
    s0, sm, sp = take_lane(S, d0), take_lane(S, d0 - 1), take_lane(S, d0 + 1)
    i32 = lambda a: a.to(torch.int32)  # noqa: E731
    return i32(minS), i32(best), i32(sm), i32(s0), i32(sp), unique_ok


def subpixel_disp16(best, sm, s0, sp, ndisp: int) -> torch.Tensor:
    """cv2's subpixel parabola in 1/16 px, truncating integer division; the edges keep d*16."""
    denom2 = torch.clamp(sm + sp - 2 * s0, min=1)
    q = torch.div((sm - sp) * 16 + denom2, 2 * denom2, rounding_mode="trunc")
    inner = (best > 0) & (best < ndisp - 1)
    return torch.where(inner, best * 16 + q, best * 16).to(torch.int32)


# --------------------------------------------------------------------- LR


def lr_fail(minS, best, disp, *, W: int, min_x: int, ndisp: int, mindisp: int, max_diff: int) -> torch.Tensor:
    """cv2's LR-consistency failure mask on (B, H, Wv) valid-region maps (the right view's disparity is
    the packed projection: the winner d of least cost among left pixels x2 + d whose winner is d)."""
    B, H, Wv = minS.shape
    maxD = mindisp + ndisp
    dev = minS.device
    pack = minS.to(torch.int32) * (1 << 11) + (best.to(torch.int32) + mindisp)
    sentinel = 1 << 30
    pack_full = torch.full((B, H, W + maxD), sentinel, dtype=torch.int32, device=dev)
    pack_full[..., min_x: min_x + Wv] = pack
    best_full = torch.full((B, H, W + maxD), -1, dtype=torch.int32, device=dev)
    best_full[..., min_x: min_x + Wv] = best
    packed = torch.full((B, H, W), sentinel, dtype=torch.int32, device=dev)
    for d in range(ndisp):
        off = d + mindisp
        hit = best_full[..., off: off + W] == d
        packed = torch.minimum(packed, torch.where(hit, pack_full[..., off: off + W], sentinel))
    disp2 = torch.where(packed >= sentinel, -(1 << 10), packed & ((1 << 11) - 1))
    d_f = torch.floor(disp).to(torch.int32)
    d_c = torch.ceil(disp).to(torch.int32)
    oob = -(1 << 10)
    padl = maxD + 1
    d2p = torch.cat([torch.full((B, H, padl), oob, dtype=torch.int32, device=dev), disp2,
                     torch.full((B, H, 1), oob, dtype=torch.int32, device=dev)], dim=-1)
    v_f = torch.full((B, H, Wv), oob, dtype=torch.int32, device=dev)
    v_c = v_f.clone()
    for dd in range(mindisp - 1, maxD + 1):
        sh = d2p[..., padl + min_x - dd: padl + min_x - dd + Wv]
        v_f = torch.where(d_f == dd, sh, v_f)
        v_c = torch.where(d_c == dd, sh, v_c)
    fail_f = (v_f >= mindisp) & ((v_f - d_f).abs() > max_diff)
    fail_c = (v_c >= mindisp) & ((v_c - d_c).abs() > max_diff)
    return fail_f & fail_c


# ---------------------------------------------------------------- speckle


def nb(a: torch.Tensor, i: int, fill) -> torch.Tensor:
    """``a`` at p + OFFS[i] over the last two axes, ``fill`` outside."""
    dy, dx = OFFS[i]
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0), H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0), W + min(-dx, 0))
    out[..., yd, xd] = a[..., ys, xs]
    return out


def speckle_filter(disp: torch.Tensor, max_diff: float, max_speckle_size: int, invalid_value: float,
                   max_diameter: int | None = None) -> torch.Tensor:
    """cv2.filterSpeckles on (..., H, W) maps: 4-connected blobs of valid pixels joined where neighbours
    differ by <= max_diff; blobs of at most ``max_speckle_size`` pixels become ``invalid_value``
    (R rounds of label propagation, a parent forest's up-sweep and down-broadcast, 2R rounds of taint;
    ``max_diameter`` caps R)."""
    H, W = disp.shape[-2:]
    S = int(max_speckle_size)
    if S <= 0:
        return disp
    R = max(S - 1 if max_diameter is None else min(S - 1, int(max_diameter)), 1)
    valid = disp > invalid_value
    masks = [valid & nb(valid, i, False) & ((nb(disp, i, float("inf")) - disp).abs() <= max_diff) for i in range(4)]
    big = H * W
    lab = torch.arange(H * W, dtype=torch.int32, device=disp.device).reshape(H, W).expand(disp.shape).clone()
    A = torch.zeros(disp.shape, dtype=torch.int32, device=disp.device)
    for r in range(1, R + 1):
        new = lab
        for i in range(4):
            new = torch.where(masks[i], torch.minimum(new, nb(lab, i, big)), new)
        A = torch.where(new < lab, r, A)
        lab = new
    pdir = torch.full(disp.shape, 4, dtype=torch.int32, device=disp.device)
    for i in (3, 2, 1, 0):
        ok = masks[i] & (nb(lab, i, big) == lab) & (nb(A, i, big) < A)
        pdir = torch.where(ok, i, pdir)
    child = [nb(pdir, i, 4) == OPP[i] for i in range(4)]
    s = torch.ones(disp.shape, dtype=torch.int32, device=disp.device)
    for _ in range(R):
        out = torch.ones_like(s)
        for i in range(4):
            out = out + torch.where(child[i], nb(s, i, 0), 0)
        s = out
    total = torch.where(pdir == 4, s, 0)
    for _ in range(R):
        out = total
        for i in range(4):
            out = torch.where(pdir == i, nb(total, i, 0), out)
        total = out
    taint = torch.zeros(disp.shape, dtype=torch.bool, device=disp.device)
    for i in range(4):
        taint = taint | (masks[i] & (nb(lab, i, big) != lab))
    for _ in range(2 * R):
        out = taint
        for i in range(4):
            out = out | (masks[i] & nb(taint, i, False))
        taint = out
    remove = valid & ~taint & (total <= S)
    return torch.where(remove, torch.as_tensor(invalid_value, dtype=disp.dtype, device=disp.device), disp)


# -------------------------------------------------------------- 3D, stats


def reproject(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """(..., H, W) disparity -> (..., H, W, 3) points through Q, as broadcast sums in a fixed order."""
    H, W = disparity.shape[-2:]
    Q = Q.to(device=disparity.device, dtype=disparity.dtype)
    gu = torch.arange(W, dtype=disparity.dtype, device=disparity.device).expand(H, W)
    gv = torch.arange(H, dtype=disparity.dtype, device=disparity.device)[:, None].expand(H, W)
    vec = (gu, gv, disparity, torch.ones_like(disparity))
    out = []
    for r in range(4):
        acc = Q[r, 0] * vec[0]
        for c in range(1, 4):
            acc = acc + Q[r, c] * vec[c]
        out.append(acc)
    w = out[3]
    return torch.stack([out[0] / w, out[1] / w, out[2] / w], dim=-1)


def frame_stats(disp: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 2) [valid_fraction, median_depth]: d == 0 excluded; an even count's median averages the two
    middle values."""
    B = disp.shape[0]
    valid = (disp > 0).reshape(B, -1)
    vf = valid.to(pts.dtype).mean(dim=1)
    z = pts[..., 2].reshape(B, -1)
    keep = valid & ~torch.isnan(z)
    z, _ = torch.sort(torch.where(keep, z, float("inf")), dim=1)
    n = keep.sum(dim=1)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    zl = torch.gather(z, 1, lo[:, None])[:, 0]
    zh = torch.gather(z, 1, hi[:, None])[:, 0]
    med = torch.where(n > 0, (zl + zh) * 0.5, float("nan"))
    return torch.stack([vf, med], dim=-1)
