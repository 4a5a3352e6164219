"""Band-limited SGBM core (reference forms), plain PyTorch with a frame axis.

Port of ``stereo_vision_tpu/stereo/banded.py``. Lane k at pixel p means
the ABSOLUTE disparity s(p) + k; every cross-pixel operation (the
box window, the SGM carries) first re-indexes a neighbour's lanes into
p's band by the shift difference (``align_window``, ``align_band``).
The alignment semantics are the JAX reference's, for any shift map:

  - carries (``align_band``, fill = ``_BIG``): delta == +-G shifts the
    lanes by delta (lanes with no source get the fill), |delta| > G (or
    > 2G for diagonals when 2G < K) fills the whole row, any other delta
    (0, or 0 < |delta| < G) leaves the lanes as they are; a whole-row
    miss resets the update to the border rule L = c (``_update_banded``);
  - the window (``align_window``): the same shifts, but a lane with no
    source, or |delta| > G, takes the CENTRE pixel's own value.

These are the forms the CUDA kernels of :mod:`.banded_cuda` are held to.
Tensors carry a leading frame axis: images and shift maps are
(P, H, W), banded volumes (P, H, W, K).

Unlike the JAX reference, which gathers K lanes out of the full-D pixel
cost volume, :func:`banded_pixel_cost` computes the K lanes directly
(the full-D volume of 32 frames at 720p would be 7.5 GB). The disparity
index is clamped to [0, ndisp - 1], which is a no-op for every shift
map the hier path builds (0 <= s <= ndisp - stride * (K - 1) - 1). With
``stride > 1`` (the coarse level's strided search, at s == 0) lane k is
the disparity s + stride * k.
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.stereo.cost_cuda import _half_extrema, _xsobel_clipped
from stereo_vision_tpu_torch.stereo.sgbm import subpixel_disp16
from stereo_vision_tpu_torch.stereo.sgm_cuda import wta_scan

_BIG = 1 << 29


def lane_shift(a: torch.Tensor, d: int, fill=None) -> torch.Tensor:
    """out[..., k] = a[..., k + d] (static d). ``fill=None`` replicates the
    band edge, otherwise lanes with no source take the constant ``fill``."""
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
    """out[..., k] = a[..., k + delta] for delta in {-G, +G} (and {-2G, +2G}
    when ``diag`` and 2G < K); larger |delta| fills the row (constant
    ``fill``) or saturates at the largest supported shift (``fill=None``).
    a: (..., K); delta: (...,) int."""
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
    """Window alignment of a neighbour's lanes into the centre pixel's band:
    out[..., k] = a[..., k + delta] for delta in {-G, 0, +G}; lanes with no
    source, and every lane when |delta| > G, take ``center``'s value. When
    G >= K a +-G shift leaves no lane, so the whole row is the centre."""
    d = delta[..., None]
    K = a.shape[-1]
    if G >= K:
        up = dn = center
    else:
        up = torch.cat([a[..., G:], center[..., K - G :]], dim=-1)
        dn = torch.cat([center[..., :G], a[..., : K - G]], dim=-1)
    out = torch.where(d == G, up, torch.where(d == -G, dn, a))
    return torch.where(d.abs() > G, center, out)


def banded_pixel_cost(left, right, s, *, band: int, ndisp: int, ftzero: int, stride: int = 1) -> torch.Tensor:
    """(P, H, W, band) int16 per-pixel BT cost (sobel + raw>>2) at disparity
    d = clamp(s(p) + stride * k, 0, ndisp - 1): the lanes the JAX reference
    gathers out of ``compute_pixel_cost``'s (H, W, ndisp) volume.

    The right rows are edge-padded on the left by ndisp - 1 BEFORE their
    half-extrema are taken (slice 1's convention, ``_bt_channel_cost``)."""
    W = left.shape[-1]
    pad = ndisp - 1

    def padded(a):
        ap = torch.cat([a[..., :1].expand(*a.shape[:-1], pad), a], dim=-1)
        return (ap, *_half_extrema(ap))

    chans = []
    for lft, rgt in ((_xsobel_clipped(left, ftzero), _xsobel_clipped(right, ftzero)),
                     (left.to(torch.int32), right.to(torch.int32))):
        chans.append((lft, *_half_extrema(lft), *padded(rgt)))
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


def _clamped(n: int, off: int, device) -> torch.Tensor:
    """Indices 0..n-1 shifted by ``off`` and clamped: an edge-replicating shift."""
    return (torch.arange(n, device=device) + off).clamp(0, n - 1)


def banded_cost_volume(left, right, s, *, band: int, G: int, ndisp: int, ftzero: int = 15,
                       block_size: int = 5, stride: int = 1) -> torch.Tensor:
    """(P, H, W, band) int32 windowed banded cost at disparities s(p) +
    stride * k: the block_size^2 window sums the per-pixel banded costs of
    the neighbours ALIGNED into p's band, rows first (centre = the pixel's
    own cost), then columns (centre = the row-pass sum at p); rows and
    columns replicate at the image edge, for the cost and for s alike."""
    H, W = left.shape[-2:]
    pb = banded_pixel_cost(left, right, s, band=band, ndisp=ndisp, ftzero=ftzero, stride=stride).to(torch.int32)
    r = block_size // 2
    acc = None
    for dy in range(block_size):
        rows = _clamped(H, dy - r, s.device)
        term = align_window(pb[:, rows], s - s[:, rows], pb, G)
        acc = term if acc is None else acc + term
    out = None
    for dx in range(block_size):
        cols = _clamped(W, dx - r, s.device)
        term = align_window(acc[:, :, cols], s - s[:, :, cols], acc, G)
        out = term if out is None else out + term
    return out


def _update_banded(c, L_aligned, P1: int, P2: int):
    """SGM update from an aligned predecessor; a predecessor with no lane in
    band (min >= _BIG) resets to the border rule L = c."""
    minL = L_aligned.amin(dim=-1, keepdim=True)
    full_miss = minL >= _BIG
    minL_eff = torch.where(full_miss, 0, minL)
    fill = torch.full_like(L_aligned[..., :1], _BIG)
    Lm = torch.cat([fill, L_aligned[..., :-1]], dim=-1)
    Lp = torch.cat([L_aligned[..., 1:], fill], dim=-1)
    cand = torch.minimum(torch.minimum(L_aligned, minL_eff + P2), torch.minimum(Lm, Lp) + P1)
    return torch.where(full_miss, c, c + cand - minL_eff)


def _shift_cols(a, direction: int):
    """Shift along the column axis (-2) of (..., W, K), zero fill."""
    z = torch.zeros_like(a[..., :1, :])
    if direction > 0:
        return torch.cat([z, a[..., :-1, :]], dim=-2)
    return torch.cat([a[..., 1:, :], z], dim=-2)


def _row_delta(s, dx: int):
    """delta(y, x) = s(y, x) - s(y-1, x-dx) on (P, H, W); 0 on row 0 and
    where (y-1, x-dx) lies outside (the shifted-in zero carry)."""
    prev = s[:, :-1]
    if dx == 1:
        prev = torch.cat([s[:, 1:, :1], prev[:, :, :-1]], dim=2)
    elif dx == -1:
        prev = torch.cat([prev[:, :, 1:], s[:, 1:, -1:]], dim=2)
    return torch.cat([torch.zeros_like(s[:, :1]), s[:, 1:] - prev], dim=1)


def _scan_down(C, s, G: int, P1: int, P2: int, with_diagonals: bool):
    """Downward set over (P, H, W, K) int32: vertical, plus the (1,1) and
    (-1,1) diagonals."""
    P, H, W, K = C.shape
    dv, dd, du = _row_delta(s, 0), _row_delta(s, 1), _row_delta(s, -1)
    zero = torch.zeros((P, W, K), dtype=torch.int32, device=C.device)
    Lv = Ld = Lu = zero
    S = torch.empty_like(C)
    for y in range(H):
        c = C[:, y]
        Lv = _update_banded(c, align_band(Lv, dv[:, y], G, fill=_BIG), P1, P2)
        if with_diagonals:
            Ld = _update_banded(c, align_band(_shift_cols(Ld, 1), dd[:, y], G, diag=True, fill=_BIG), P1, P2)
            Lu = _update_banded(c, align_band(_shift_cols(Lu, -1), du[:, y], G, diag=True, fill=_BIG), P1, P2)
            S[:, y] = Lv + Ld + Lu
        else:
            S[:, y] = Lv
    return S


def vertical_plain(C, s, G: int, P1: int, P2: int, with_diagonals: bool = False):
    """(down-set sum, up-set sum), int32. The up set scans the y-flipped
    volume and shift map with the SAME column shifts."""
    C = C.to(torch.int32)
    s = s.to(torch.int32)
    P = C.shape[0]
    S = _scan_down(torch.cat([C, C.flip(1)]), torch.cat([s, s.flip(1)]), G, P1, P2, with_diagonals)
    return S[:P], S[P:].flip(1)


def horizontal_plain(C, s, G: int, P1: int, P2: int, reverse: bool = False):
    """The L->R (``reverse``: R->L) direction volume, int32; the carry is
    aligned by s(x) - s(x-1) (R->L: s(x) - s(x+1)), 0 at the first column."""
    C = C.to(torch.int32)
    s = s.to(torch.int32)
    if reverse:
        return horizontal_plain(C.flip(2), s.flip(2), G, P1, P2).flip(2)
    P, H, W, K = C.shape
    dh = torch.cat([torch.zeros_like(s[:, :, :1]), s[:, :, 1:] - s[:, :, :-1]], dim=2)
    L = torch.zeros((P, H, K), dtype=torch.int32, device=C.device)
    S = torch.empty_like(C)
    for x in range(W):
        L = _update_banded(C[:, :, x], align_band(L, dh[:, :, x], G, fill=_BIG), P1, P2)
        S[:, :, x] = L
    return S


def aggregate_banded_scan(C, s, G: int, P1: int, P2: int, num_paths: int = 8) -> torch.Tensor:
    """Banded 8/4/3/2-direction aggregation, int32 (P, H, W, K).
    C: banded windowed cost; s: shift map on the same columns."""
    if num_paths not in (2, 3, 4, 8):
        raise ValueError(f"num_paths must be 2, 3, 4 or 8, got {num_paths}")
    s_dn, s_up = vertical_plain(C, s, G, P1, P2, num_paths >= 8)
    S = s_dn + s_up
    if num_paths >= 3:
        S = S + horizontal_plain(C, s, G, P1, P2)
    if num_paths == 4 or num_paths == 8:
        S = S + horizontal_plain(C, s, G, P1, P2, reverse=True)
    return S


def banded_stats_scan(left, right, s, params, band: int, G: int, min_x: int, stride: int = 1, sub: bool = False):
    """Banded core: cost + aggregation + WTA on columns x >= min_x of
    (P, H, W) inputs. Returns (minS, best_k, sm, s0, sp, unique_ok) maps of
    shape (P, H, W - min_x); with ``sub``, (minS, best_k, sub16, unique_ok)
    with the subpixel parabola in lane units (ndisp = band).
    Absolute disparity = stride * best_k + s[..., min_x:]."""
    C = banded_cost_volume(left, right, s, band=band, G=G, ndisp=params.num_disparities, ftzero=params.ftzero,
                           block_size=params.block_size, stride=stride)[:, :, min_x:]
    S = aggregate_banded_scan(C, s[:, :, min_x:], G, params.P1, params.P2, params.num_paths)
    minS, best, sm, s0, sp, uok = wta_scan(S, band, params.uniqueness_ratio)
    if sub:
        return minS, best, subpixel_disp16(best, sm, s0, sp, band), uok
    return minS, best, sm, s0, sp, uok
