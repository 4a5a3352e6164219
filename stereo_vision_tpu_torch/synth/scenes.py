"""Synthetic stereo scenes of the repo's benchmark (numpy only).

The port's own copies of ``bench.py``'s ``_scene``, ``_scene_occ`` and
``_agreement``, with the frame size as a parameter (the bench fixes
1280x720), plus the ramp+box scene's true disparity.
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
