"""Ball detection scoring and monocular depth.

Port of ``stereo_vision_tpu/detect/ball.py``: circularity rescoring of
detector boxes, the HSV colour boost, and the pinhole depth-from-size
helpers. The crops are scored on ``device`` (None: the CUDA card); the
box loop and the choice stay on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.circles import region_circularity
from stereo_vision_tpu_torch.detect.image_ops import in_range, rgb_to_gray, rgb_to_hsv
from stereo_vision_tpu_torch.ops.rotation import as_tensor


class BallDetection(NamedTuple):
    cx: float
    cy: float
    radius: float
    confidence: float


# HSV ranges in cv2 8-bit convention (H in [0,180)).
ORANGE_HSV_RANGE = (np.array([5.0, 120.0, 120.0]), np.array([25.0, 255.0, 255.0]))
BLUE_HSV_RANGE = (np.array([100.0, 150.0, 50.0]), np.array([140.0, 255.0, 255.0]))


def color_fraction(region_rgb, hsv_range=ORANGE_HSV_RANGE, device=None) -> float:
    """Percentage of a crop's pixels inside an HSV range: the count times
    the float32 reciprocal of the pixel count, as XLA lowers the
    reference's float32 mean (and alike on every device)."""
    mask = in_range(rgb_to_hsv(as_tensor(region_rgb, device)), hsv_range[0], hsv_range[1])
    inv = torch.tensor(1.0, dtype=torch.float32) / mask.numel()
    return float(mask.sum(dtype=torch.float32) * inv.to(mask.device) * 100.0)


def rescore_detections(
    image_rgb,
    boxes: Sequence[tuple[float, float, float, float, float]],
    conf_threshold: float = 0.25,
    color_range=None,
    device=None,
) -> BallDetection | None:
    """The best ball among (x1, y1, x2, y2, conf) boxes.

    Centre and radius from the box, a crop with a 0.5-radius margin, Otsu +
    circularity 4 pi A / P^2, adjusted conf = conf * (0.5 + 0.5 circularity);
    with a colour range, first the colour boost (>= 30% coloured pixels
    boosts up to 1.0, else a 0.7 penalty), then conf * min(1, circ + 0.2).
    An array goes to ``device`` once (None: the card), a tensor stays."""
    H, W = image_rgb.shape[0], image_rgb.shape[1]
    img = None
    best: BallDetection | None = None
    for x1, y1, x2, y2, conf in boxes:
        if conf <= conf_threshold:
            continue
        cx = (x1 + x2) / 2.0
        cy = (y1 + y2) / 2.0
        radius = ((x2 - x1) + (y2 - y1)) / 4.0
        margin = radius * 0.5
        cx1, cy1 = max(0, int(x1 - margin)), max(0, int(y1 - margin))
        cx2, cy2 = min(W, int(x2 + margin)), min(H, int(y2 + margin))
        if cx2 <= cx1 or cy2 <= cy1:
            continue
        if img is None:
            img = as_tensor(image_rgb, device)
        region = img[cy1:cy2, cx1:cx2]
        if region.numel() == 0:
            continue

        adjusted = conf
        if color_range is not None:
            pct = color_fraction(region, color_range)
            if pct > 30.0:
                adjusted = conf * min(1.0, pct / 100.0 + 0.3)
            else:
                adjusted = conf * 0.7

        circ = float(region_circularity(rgb_to_gray(region)))
        if color_range is not None:
            adjusted = adjusted * min(1.0, circ + 0.2)
        else:
            adjusted = adjusted * (0.5 + 0.5 * circ)

        if best is None or adjusted > best.confidence:
            best = BallDetection(cx, cy, radius, adjusted)
    return best


def depth_from_apparent_size(diameter_px: float, known_diameter_mm: float, focal_px: float) -> float:
    """Monocular pinhole depth Z = D*f/d."""
    return known_diameter_mm * focal_px / max(diameter_px, 1e-9)


def estimate_focal_length(diameter_px: float, known_distance_mm: float, known_diameter_mm: float) -> float:
    """f = d_px * Z / D from one observation of a known object at a known
    distance."""
    return diameter_px * known_distance_mm / max(known_diameter_mm, 1e-9)
