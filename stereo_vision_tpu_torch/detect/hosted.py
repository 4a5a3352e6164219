"""Hosted-API ball detector client with a pluggable transport.

Port of ``stereo_vision_tpu/detect/hosted.py``: hosted-model prediction ->
image-hash result cache -> ball-colour HSV gate -> circularity-gated
min-enclosing-circle refinement -> size gate. The transport is any
callable returning predictions in the hosted API's schema ({"x", "y",
"width", "height", "confidence"} in pixels, centres and sizes). The image
math runs on the client's ``device`` (None: the CUDA card); the in-repo
detector's transport (``local_transport``) is not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.ball import BallDetection, color_fraction
from stereo_vision_tpu_torch.detect.cache import DetectionCache
from stereo_vision_tpu_torch.detect.circles import (
    largest_component_mask,
    mask_circularity,
    min_enclosing_circle,
    otsu_foreground,
)
from stereo_vision_tpu_torch.detect.image_ops import binary_dilate, binary_erode, in_range, rgb_to_hsv
from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.rotation import as_tensor

# The reference's blue-ball HSV range, OpenCV scaling (H in [0, 180)).
ROBOFLOW_BLUE_HSV_RANGE = ((100, 50, 50), (130, 255, 255))

Prediction = dict
Transport = Callable[[np.ndarray], Sequence[Prediction]]


def _refine_circle(region_rgb, hsv_range=None, device=None) -> tuple[float, float, float] | None:
    """Circularity-gated min-enclosing-circle refinement of a ball crop:
    (cx, cy, radius) in crop coordinates, or None.

    The mask is the colour range's (when set and it holds >= 100 pixels),
    else an Otsu split of the channel mean with border-contact polarity.
    An opening radius k sweeps 0..max_k (erode^k -> largest component ->
    dilate^k, within the mask); the most circular blob of >= 100 pixels
    and circularity > 0.7 wins. Every k's mask, area and circularity are
    made on the device and read back together: three reads a crop where
    the reference reads two a k."""
    region = as_tensor(region_rgb, device)
    mask = None
    if hsv_range is not None:
        cmask = in_range(rgb_to_hsv(region), hsv_range[0], hsv_range[1])
        if int(cmask.sum()) >= 100:
            mask = cmask
    if mask is None:
        # The channel mean as numpy's: a true division (on the card PyTorch
        # divides by a host scalar as a multiply by its reciprocal).
        three = torch.tensor(3.0, device=region.device)
        mask = otsu_foreground(region.to(torch.float32).sum(-1) / three)

    max_k = max(2, min(region.shape[:2]) // 24)
    masks, eroded = [], mask
    for k in range(max_k + 1):
        m = largest_component_mask(eroded)
        for _ in range(k):
            m = binary_dilate(m)
        masks.append(m & mask)
        eroded = binary_erode(eroded)
    stats = torch.stack([torch.stack([m.sum().to(torch.float32), mask_circularity(m)]) for m in masks]).cpu()
    best, best_circ = None, 0.7  # the reference's rule: circularity must exceed 0.7
    for m, (area, circ) in zip(masks, stats.tolist()):
        if area >= 100 and circ > best_circ:  # and contourArea >= 100
            best_circ, best = circ, m
    if best is None:
        return None
    cx, cy, r = min_enclosing_circle(best).tolist()
    return cx, cy, r


class HostedDetectorClient:
    """Cached hosted-model ball detector with colour + circularity gating.

    Args:
      transport: prediction callable (see the module docstring).
      cache_path: optional DetectionCache pickle path (image-hash keyed).
      hsv_range: ball colour gate; colour percentage > ``color_min_percent``
        keeps a prediction in the colour-filtered pool.
      radius_range: plausible ball radius in px.
      device: where the crops are scored (None: the CUDA card).
    """

    def __init__(
        self,
        transport: Transport,
        cache_path: str | Path | None = None,
        conf_threshold: float = 0.5,
        hsv_range=ROBOFLOW_BLUE_HSV_RANGE,
        color_min_percent: float = 10.0,
        radius_range: tuple[float, float] = (10.0, 300.0),
        device=None,
    ):
        self.transport = transport
        self.cache = DetectionCache(cache_path) if cache_path else None
        self.conf_threshold = conf_threshold
        self.hsv_range = hsv_range
        self.color_min_percent = color_min_percent
        self.radius_range = radius_range
        self.device = resolve_device(device)
        self.calls = 0  # transport invocations (cache hits skip these)

    # Cache entry marking "transport ran, nothing detected": no-ball
    # frames must not re-invoke a paid hosted endpoint on every pass.
    _NO_DETECTION = "no_detection"

    def detect(self, image: np.ndarray) -> BallDetection | None:
        """(H, W, 3) uint8 RGB frame -> best BallDetection or None."""
        if self.cache is not None:
            hit = self.cache.get(image)
            if hit is not None:
                return None if hit == self._NO_DETECTION else hit

        self.calls += 1
        preds = [p for p in self.transport(image) if p["confidence"] >= self.conf_threshold]
        result = self._select(image, preds)
        if self.cache is not None:
            self.cache.put(image, self._NO_DETECTION if result is None else result)
        return result

    def _select(self, image: np.ndarray, preds: Sequence[Prediction]) -> BallDetection | None:
        H, W = image.shape[:2]
        img = None

        def crop(cx, cy, half_w, half_h):
            nonlocal img
            if img is None:  # the frame goes to the device once
                img = as_tensor(image, self.device)
            x1, y1 = max(0, int(cx - half_w)), max(0, int(cy - half_h))
            x2, y2 = min(W, int(cx + half_w)), min(H, int(cy + half_h))
            return img[y1:y2, x1:x2], x1, y1

        # Colour gate: prefer predictions whose box holds enough ball colour
        # (hsv_range=None: no colour gate).
        colored = []
        if self.hsv_range is not None:
            for p in preds:
                region, _, _ = crop(p["x"], p["y"], p["width"] / 2, p["height"] / 2)
                if region.numel() and color_fraction(region, self.hsv_range) > self.color_min_percent:
                    colored.append(p)
        pool = colored or list(preds)
        if not pool:
            return None
        best = max(pool, key=lambda p: p["confidence"])
        cx, cy = float(best["x"]), float(best["y"])
        radius = (float(best["width"]) + float(best["height"])) / 4
        conf = float(best["confidence"])

        # Circularity refinement on a 1.5-radius crop.
        region, x1, y1 = crop(cx, cy, radius * 1.5, radius * 1.5)
        if region.numel():
            refined = _refine_circle(region, self.hsv_range)
            if refined is not None:
                rx, ry, rr = refined
                lo, hi = self.radius_range
                if lo <= rr <= hi:
                    return BallDetection(cx=rx + x1, cy=ry + y1, radius=rr, confidence=conf)
        lo, hi = self.radius_range
        if lo <= radius <= hi:
            return BallDetection(cx=cx, cy=cy, radius=radius, confidence=conf)
        return None

    def save_cache(self) -> None:
        if self.cache is not None:
            self.cache.save()
