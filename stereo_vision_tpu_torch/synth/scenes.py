"""Synthetic stereo scenes of the repo's benchmark (numpy only).

The port's own copies of ``bench.py``'s ``_scene``, ``_scene_occ`` and
``_agreement``, with the frame size as a parameter (the bench fixes
1280x720), plus the ramp+box scene's true disparity, disparity maps
made to break a speckle filter (:func:`speckle_patterns`), and two
unsynchronised streams of scenes with a flash (:func:`flash_streams`),
and a shaded ball drawn without OpenCV (:func:`draw_ball`, :func:`ball_frame`).
"""

from __future__ import annotations

import numpy as np


def _smooth_texture(rng, shape):
    t = rng.uniform(0, 255, shape).astype(np.float32)
    for _ in range(2):
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1) + np.roll(t, 1, 0) + np.roll(t, -1, 0)) / 5.0
    return (t - t.min()) / (np.ptp(t) + 1e-9) * 255.0


def scene_truth(H: int = 720, W: int = 1280, box_disp: float = 90.0) -> np.ndarray:
    """(H, W) float32 true disparity of :func:`scene`: ramps 20..80 plus a
    ``box_disp`` px box over the middle ninth."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    disp = 20.0 + 40.0 * xx / W + 20.0 * yy / H
    disp[H // 3 : 2 * H // 3, W // 3 : 2 * W // 3] = box_disp
    return disp


def scene(seed: int = 0, box_disp: float = 90.0, H: int = 720, W: int = 1280):
    """Textured (left, right) int32 pair with disparity ramps (20..80) and
    a ``box_disp`` px foreground box (``bench.py::_scene``)."""
    rng = np.random.default_rng(seed)
    pad = 160
    base = _smooth_texture(rng, (H, W + pad))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    xs = xx + pad - scene_truth(H, W, box_disp)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W + pad - 2)
    f = xs - x0
    yi = yy.astype(np.int64)
    left = base[yi, x0] * (1 - f) + base[yi, x0 + 1] * f
    right = base[:, pad : pad + W]
    left = np.clip(left + rng.normal(0, 1.5, (H, W)), 0, 255).astype(np.int32)
    right = np.clip(right + rng.normal(0, 1.5, (H, W)), 0, 255).astype(np.int32)
    return left, right


def scene_occ(seed: int = 2, H: int = 720, W: int = 1280):
    """True-occlusion pair: a d=85 foreground square composited over a
    background ramp (``bench.py::_scene_occ``)."""
    rng = np.random.default_rng(seed)
    pad = 160
    base = _smooth_texture(rng, (H, W + pad))
    fg = _smooth_texture(rng, (H, W))  # foreground texture in right coordinates
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    disp_bg = 15.0 + 25.0 * xx / W + 10.0 * yy / H
    xs = xx + pad - disp_bg
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W + pad - 2)
    f = xs - x0
    yi = yy.astype(np.int64)
    left = base[yi, x0] * (1 - f) + base[yi, x0 + 1] * f
    right = base[:, pad : pad + W].copy()
    df = 85  # integer: the composite shift is exact
    box_r = (yy >= H // 4) & (yy < H // 2) & (xx >= W // 2) & (xx < 3 * W // 4)
    right[box_r] = fg[box_r]
    xl = np.clip(xx.astype(np.int64) - df, 0, W - 1)
    box_l = box_r[yi, xl] & (xx.astype(np.int64) - df >= 0)
    left[box_l] = fg[yi, xl][box_l]
    left = np.clip(left + rng.normal(0, 1.5, (H, W)), 0, 255).astype(np.int32)
    right = np.clip(right + rng.normal(0, 1.5, (H, W)), 0, 255).astype(np.int32)
    return left, right


def agreement(out: np.ndarray, ref: np.ndarray) -> float:
    """Share of pixels where both are invalid (<= -1) or both valid within 1 px."""
    rv = ref > -1
    mv = out > -1
    both = rv & mv
    return float(((~rv & ~mv) | (both & (np.abs(out - ref) <= 1.0))).mean())


def speckle_patterns() -> np.ndarray:
    """(7, 72, 100) float32 disparity maps, invalid -1, whose blobs join
    where values are equal (max_diff 1): a 19-px snake of diameter 18 beside
    a compact 2-px blob and a 3x3 blob; a U and a blob inside another; a
    spiral; blobs whose least-index pixel is not their top-left corner (a
    walk from it must reach left); a comb over 3 x 4 tiles of 32 x 32 and a
    small blob below it; an all-valid constant frame; a checkerboard of
    single pixels."""
    F = np.full((7, 72, 100), -1.0, np.float32)
    F[0, 1, 1:11] = F[0, 1:4, 10] = F[0, 3, 3:11] = 10  # snake
    F[0, 6, 2:4] = 5
    F[0, 20:23, 40:43] = 3
    F[1, 10:16, 10] = F[1, 15, 10:16] = F[1, 10:16, 15] = 4  # U of 16
    F[1, 40:44, 60:64] = 4
    F[1, 41:43, 61:63] = 6
    y, x = 30, 30
    F[2, y, x] = 7
    for dy, dx in [(0, 1)] * 6 + [(1, 0)] * 6 + [(0, -1)] * 6 + [(-1, 0)] * 4 + [(0, 1)] * 4 + [(1, 0)] * 2:
        y, x = y + dy, x + dx
        F[2, y, x] = 7  # a spiral of 29
    F[3, 10, 20:23] = F[3, 11, 15:21] = 2  # least index (10, 20), corner (10, 15) empty
    for k in range(8):
        F[3, 50 + k, 60 - k : 62 - k] = 3  # a staircase down and to the left
    F[3, 30:33, 80] = F[3, 32, 75:80] = 5  # an L whose walk runs back left
    F[4, 5, 2:98] = 9
    for x in range(2, 98, 6):
        F[4, 5:65, x] = 9  # a comb
    F[4, 67:70, 30:34] = 9
    F[5] = 12.0
    F[6] = np.where(np.indices((72, 100)).sum(0) % 2 == 0, 2.0, -1.0)
    return F


WTA_MODES = ("random", "ties", "ends", "boundary", "near_bound")


def wta_volumes(rng, shape, mode: str, nvol: int = 3, dtype=np.int16) -> list[np.ndarray]:
    """``nvol`` direction volumes of ``shape`` (..., K) made to break a
    banded WTA: "random"; "ties" (every lane equal on a third of the pixels,
    two minima 1 or 2 lanes apart on the rest); "ends" (the minimum at lane
    0, or at lane K - 1 on every other pixel); "boundary" (a lane 2 or more
    from the minimum exactly at the uniqueness boundary of ratio 10, minS *
    110 == S[k] * 100, which passes, or one below it); "near_bound" (int32
    volumes whose sum lies within 2^24 of 2^31 - 1, so that the uniqueness
    products wrap). The sum of the volumes is the pattern; the split between
    them is random."""
    K = shape[-1]
    if mode == "near_bound":
        top = (2**31 - 1) // nvol
        return [rng.integers(top - (1 << 22), top, shape).astype(np.int32) for _ in range(nvol)]
    S = rng.integers(2000, 6000, shape).astype(np.int64)
    flat = S.reshape(-1, K)
    n = flat.shape[0]
    if mode == "ties":
        k = rng.integers(0, max(K - 2, 1), n)
        gap = 1 + np.arange(n) % 2
        flat[np.arange(n), k] = 1000
        flat[np.arange(n), np.minimum(k + gap, K - 1)] = 1000
        flat[::3] = 3000
    elif mode == "ends":
        flat[:, 0] = 1000
        flat[::2, K - 1] = 900
    elif mode == "boundary":
        flat[:, 0] = 1000
        flat[:, K - 1] = 1100 - np.arange(n) % 2  # 1100 passes, 1099 fails (K >= 3)
    elif mode != "random":
        raise ValueError(f"unknown mode {mode}")
    parts = [rng.integers(0, 400, shape) for _ in range(nvol - 1)]
    first = S - sum(parts)
    return [a.astype(dtype) for a in (first, *parts)]


LR_MODES = ("random", "one_disparity", "negative", "edges")


def lr_maps(rng, shape, ndisp: int, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """The packed LR check's int32 (pack, d16) maps of ``shape`` (..., Wv):
    WTA-like winners and costs with ties, d16 within half a pixel of the
    winner; "one_disparity" (every row at one winner and one cost: every
    scatter of a row collides), "negative" (d16 < 0 on a third of the
    pixels), "edges" (lookups at the shifts -1 and ndisp and beyond them)."""
    rows = shape[:-1]
    cost = rng.integers(0, 60, shape)
    best = rng.integers(0, ndisp, shape)
    d16 = np.clip(best * 16 + rng.integers(-8, 9, shape), 0, None)
    if mode == "one_disparity":
        cost[:] = 7
        best = np.broadcast_to(rng.integers(0, ndisp, (*rows, 1)), shape).copy()
        d16 = best * 16 + rng.integers(-8, 9, shape)
    elif mode == "negative":
        d16 = np.where(rng.random(shape) < 0.33, rng.integers(-40, 0, shape), d16)
    elif mode == "edges":
        edge = rng.choice([-33, -17, -16, -1, 16 * ndisp - 15, 16 * ndisp, 16 * ndisp + 16, 16 * ndisp + 40], shape)
        d16 = np.where(rng.random(shape) < 0.5, edge, d16)
    elif mode != "random":
        raise ValueError(f"unknown mode {mode}")
    return (cost * 2048 + best).astype(np.int32), d16.astype(np.int32)


def flash_streams(n_frames: int, lag: int, flash_at: int, H: int = 720, W: int = 1280, distinct: int = 8,
                  boost: float = 80.0, swing: float = 15.0, period: float = 50.0) -> tuple[np.ndarray, np.ndarray]:
    """Two (n_frames, H, W) uint8 streams of a stereo rig whose right camera
    started ``lag`` frames late: right frame j + lag shows the instant of
    left frame j. Instant t is :func:`scene` ``t mod distinct`` (its left
    and right views) under a light level ``swing * sin(2 pi t / period)``
    shared by both cameras; at instant ``flash_at`` (left frame ``flash_at``,
    right frame ``flash_at + lag``) a flash adds ``boost``, clipped at 255.
    The light swings slowly enough that no other frame jumps 20 above the
    mean of the 5 before it; the light level and the flash mark the
    instants, so that content matching finds the lag too."""
    views = [scene(seed=s, H=H, W=W) for s in range(distinct)]

    def frame(t: int, side: int) -> np.ndarray:
        level = swing * np.sin(2 * np.pi * t / period) + (boost if t == flash_at else 0.0)
        return np.clip(views[t % distinct][side] + level, 0, 255).astype(np.uint8)

    left = np.stack([frame(t, 0) for t in range(n_frames)])
    right = np.stack([frame(j - lag, 1) for j in range(n_frames)])
    return left, right


def _disk_cover(h: int, w: int, cx: float, cy: float, r: float, inner: float = -1.0, ss: int = 4) -> np.ndarray:
    """(h, w) float32 share of each pixel inside the ring inner < d <= r
    around (cx, cy) (a disk for inner < 0), from ss x ss samples a pixel,
    pixel centres at integer coordinates."""
    sub = (np.arange(ss) + 0.5) / ss - 0.5
    ys = (np.arange(h)[:, None] + sub[None, :]).reshape(-1)
    xs = (np.arange(w)[:, None] + sub[None, :]).reshape(-1)
    d2 = (ys[:, None] - cy) ** 2 + (xs[None, :] - cx) ** 2
    inside = (d2 <= r * r) & (d2 > inner * inner if inner >= 0 else True)
    return inside.reshape(h, ss, w, ss).mean(axis=(1, 3)).astype(np.float32)


def _paint(img: np.ndarray, cover: np.ndarray, y0: int, x0: int, color) -> None:
    """Blend ``color`` into ``img`` by the coverage of its (y0, x0) window."""
    h, w = cover.shape
    win = img[y0 : y0 + h, x0 : x0 + w].astype(np.float32)
    a = cover[..., None]
    img[y0 : y0 + h, x0 : x0 + w] = np.rint(win * (1 - a) + np.asarray(color, np.float32) * a).astype(img.dtype)


def draw_ball(img: np.ndarray, cx: float, cy: float, r: float, color=(255, 120, 30)) -> None:
    """Shaded ball, anti-aliased, in place on an (H, W, 3) uint8 image: a
    disk of radius round(r) at (round(cx), round(cy)), a rim darker by 0.55
    and max(ri // 6, 1) wide on its edge, and a (250, 250, 250) highlight of
    radius max(ri // 4, 1) up and left of the centre (the JAX package's
    OpenCV drawing's layout; not its pixels)."""
    H, W = img.shape[:2]
    c = (int(round(cx)), int(round(cy)))
    ri = max(int(round(r)), 2)
    rim_w = max(ri // 6, 1)
    hi_c, hi_r = (int(c[0] - ri * 0.3), int(c[1] - ri * 0.3)), max(ri // 4, 1)
    rim = tuple(max(int(v * 0.55), 0) for v in color)
    for (px, py), rad, inner, col in ((c, ri + rim_w / 2, -1.0, color), (c, ri + rim_w / 2, ri - rim_w / 2, rim),
                                      (hi_c, hi_r, -1.0, (250, 250, 250))):
        y0, x0 = max(int(np.floor(py - rad - 1)), 0), max(int(np.floor(px - rad - 1)), 0)
        y1, x1 = min(int(np.ceil(py + rad + 2)), H), min(int(np.ceil(px + rad + 2)), W)
        if y1 > y0 and x1 > x0:
            _paint(img, _disk_cover(y1 - y0, x1 - x0, px - x0, py - y0, rad, inner), y0, x0, col)


def ball_frame(seed: int, H: int = 720, W: int = 1280, cx: float = 640.0, cy: float = 360.0, r: float = 40.0,
               color=(30, 90, 230)) -> np.ndarray:
    """(H, W, 3) uint8 RGB frame: a smooth gray-green texture (values 60-160)
    with a ball drawn at (cx, cy), radius r (blue by default: inside the
    hosted detector's colour range)."""
    rng = np.random.default_rng(seed)
    t = 60.0 + _smooth_texture(rng, (H, W)) * (100.0 / 255.0)
    img = np.stack([t * 0.9, t, t * 0.8], axis=-1).astype(np.uint8)
    draw_ball(img, cx, cy, r, color)
    return img
