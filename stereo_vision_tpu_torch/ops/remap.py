"""Bilinear remap (undistort/rectify resampling), gather form.

Port of ``stereo_vision_tpu/ops/remap.py::remap_bilinear`` and
``make_remap``. The JAX package's one-hot MXU variants are TPU devices
and have no counterpart: on the card an indexed load is the direct form.
Out-of-range taps read 0 (cv2 BORDER_CONSTANT). The four taps are summed
in the reference's order, so a rounding tie falls the same way.
"""

from __future__ import annotations

from typing import Callable

import torch


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """(..., H, W) source images + (Ho, Wo) float source coordinates ->
    (..., Ho, Wo) float32 resampled images."""
    H, W = img.shape[-2:]
    imgf = img.to(torch.float32).reshape(*img.shape[:-2], H * W)
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)
        v = imgf[..., flat].reshape(*img.shape[:-2], *map_x.shape)
        return torch.where(valid, v, 0.0)

    return (
        tap(y0i, x0i) * (1 - fx) * (1 - fy)
        + tap(y0i, x0i + 1) * fx * (1 - fy)
        + tap(y0i + 1, x0i) * (1 - fx) * fy
        + tap(y0i + 1, x0i + 1) * fx * fy
    )


def make_remap(map_x: torch.Tensor, map_y: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``remap(img) -> out`` for fixed maps (the gather form on every device)."""
    return lambda img: remap_bilinear(img, map_x, map_y)
