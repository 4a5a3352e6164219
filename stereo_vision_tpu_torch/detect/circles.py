"""Circle detection and shape scoring.

Port of ``stereo_vision_tpu/detect/circles.py`` (the cv2.HoughCircles,
contour circularity and minEnclosingCircle replacements):

- Hough voting: each radius plane is the 2-D convolution of the edge map
  with a ring of ones, divided by the ring's pixel count, as a float64 FFT
  product (a direct convolution with rings up to 201 px wide is far slower
  on the CPU). On a 0/1 edge map the convolution's counts are integers,
  made exact by rounding, so the card's accumulator equals the CPU's bit
  for bit; any other map keeps its unrounded sums. The reference
  convolves with the normalised ring, which rounds each product: the two
  agree within float32 rounding;
- circularity 4 pi A / P^2 from the mask's area and boundary pixel count;
- the min enclosing circle from the mask's centroid and farthest pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.image_ops import binary_erode, otsu_binarize, sobel_magnitude, sqrt32
from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.stereo.postprocess import connected_component_labels


class Circle(NamedTuple):
    cx: float
    cy: float
    radius: float
    score: float


def _ring(radius: int, device, thickness: float = 1.0) -> torch.Tensor:
    """(2r+1, 2r+1) float64 ring of ones at distance ``radius`` from the
    centre (the reference's ``_ring_kernel`` before its normalisation)."""
    ar = torch.arange(-radius, radius + 1, dtype=torch.float64, device=device)
    return ((torch.sqrt(ar[:, None] ** 2 + ar[None, :] ** 2) - radius).abs() <= thickness).to(torch.float64)


def hough_accumulator(edges: torch.Tensor, radii: tuple[int, ...]) -> torch.Tensor:
    """(R, H, W) float32 vote maps of an (H, W) float edge-strength map:
    plane r is the map convolved with ring_r ("same" size, zeros outside),
    over the ring's pixel count.

    The convolution is a float64 FFT product on a frame padded by the
    largest radius (so the circular product is the linear one). Where the
    map is all 0/1 its sums are integer counts and are rounded to them,
    exact on every device (the FFT's rounding error is many orders of
    magnitude below 0.5 at these sizes); the choice is made on the device,
    without a read-back."""
    H, W = edges.shape
    Hs, Ws = size = (H + max(radii), W + max(radii))
    e = edges.to(torch.float64)
    binary = ((e == 0) | (e == 1)).all()
    spec = torch.fft.rfft2(e, s=size)
    outs = []
    for r in radii:
        ring = _ring(r, edges.device)
        k = torch.zeros(size, dtype=torch.float64, device=edges.device)
        k[: r + 1, : r + 1] = ring[r:, r:]  # the ring's centre at (0, 0), negative offsets wrapped
        k[: r + 1, Ws - r :] = ring[r:, :r]
        k[Hs - r :, : r + 1] = ring[:r, r:]
        k[Hs - r :, Ws - r :] = ring[:r, :r]
        sums = torch.fft.irfft2(spec * torch.fft.rfft2(k), s=size)[:H, :W]
        sums = torch.where(binary, torch.round(sums) + 0.0, sums)  # + 0.0: no -0
        outs.append(sums.to(torch.float32) / ring.sum().to(torch.float32))
    return torch.stack(outs)


def hough_circles(
    img,
    min_radius: int = 10,
    max_radius: int = 100,
    radius_step: int = 2,
    edge_threshold: float = 100.0,
    vote_threshold: float = 0.25,
    min_dist: int = 100,
    max_circles: int = 4,
    device=None,
) -> list[Circle]:
    """Circles with cv2.HoughCircles-like behaviour (dp=1, minDist 100):
    up to ``max_circles`` by vote score, centres within ``min_dist`` of a
    stronger one suppressed (greedily, on the host).

    ``img``: an (H, W) tensor (runs on its device) or array (goes to
    ``device``; None: the CUDA card). One read-back a call."""
    mag, _, _ = sobel_magnitude(as_tensor(img, device))
    edges = (mag > edge_threshold).to(torch.float32)
    radii = tuple(range(min_radius, max_radius + 1, radius_step))
    acc = hough_accumulator(edges, radii)
    # The first of equal planes, as numpy's argmax; one read-back.
    best = torch.stack([acc.amax(dim=0), acc.argmax(dim=0).to(torch.float32)]).cpu().numpy()
    best_v, best_r = best[0], best[1].astype(np.int64)
    found: list[Circle] = []
    flat = best_v.ravel().argsort()[::-1]
    H, W = best_v.shape
    for idx in flat[: 50 * max_circles]:
        v = best_v.ravel()[idx]
        if v < vote_threshold:
            break
        cy, cx = divmod(int(idx), W)
        if any((cx - c.cx) ** 2 + (cy - c.cy) ** 2 < min_dist**2 for c in found):
            continue
        found.append(Circle(float(cx), float(cy), float(radii[best_r[cy, cx]]), float(v)))
        if len(found) >= max_circles:
            break
    return found


def mask_circularity(mask: torch.Tensor) -> torch.Tensor:
    """4 pi A / P^2 of a boolean mask (0 for an empty one): the area is the
    pixel count, the perimeter the pixels the 4-neighbour erosion removes."""
    m = mask.to(torch.float32)
    area = m.sum()
    perimeter = (m - binary_erode(mask.bool()).to(torch.float32)).sum()
    return torch.where(perimeter > 0, 4.0 * math.pi * area / (perimeter * perimeter), 0.0)


def largest_component_mask(mask: torch.Tensor) -> torch.Tensor:
    """A boolean mask restricted to its largest 4-connected component (the
    first of equal sizes in label order), by
    :func:`~stereo_vision_tpu_torch.stereo.postprocess.connected_component_labels`
    and its fixed rounds: as in the reference, a long thin blob the rounds
    leave split keeps only its largest part."""
    H, W = mask.shape
    pad = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    adjacency = [mask & pad[1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]
                 for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1))]
    labels = connected_component_labels(adjacency, mask)
    counts = torch.zeros(H * W, dtype=torch.int32, device=mask.device)
    counts.index_add_(0, labels.reshape(-1).long(), mask.reshape(-1).to(torch.int32))
    return mask & (labels == torch.argmax(counts))


def min_enclosing_circle(mask: torch.Tensor) -> torch.Tensor:
    """(cx, cy, r) float32 of a boolean mask: its centroid and the largest
    distance from it to a set pixel (cv2.minEnclosingCircle stand-in)."""
    m = mask.to(torch.float32)
    H, W = m.shape
    total = m.sum().clamp(min=1e-9)
    ys = torch.arange(H, dtype=torch.float32, device=mask.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=mask.device)[None, :].expand(H, W)
    cy = (m * ys).sum() / total
    cx = (m * xs).sum() / total
    d = sqrt32((ys - cy) ** 2 + (xs - cx) ** 2)
    r = torch.where(m > 0, d, 0.0).max()
    return torch.stack([cx, cy, r])


def otsu_foreground(gray_region: torch.Tensor) -> torch.Tensor:
    """Otsu mask of a crop, its polarity the side with less border contact
    (balls rarely touch the crop border)."""
    fg = otsu_binarize(gray_region)
    border = fg[0].sum() + fg[-1].sum() + fg[:, 0].sum() + fg[:, -1].sum()
    border_inv = (~fg[0]).sum() + (~fg[-1]).sum() + (~fg[:, 0]).sum() + (~fg[:, -1]).sum()
    return torch.where(border > border_inv, ~fg, fg)


def region_circularity(gray_region: torch.Tensor) -> torch.Tensor:
    """Circularity of a gray crop's Otsu foreground (the reference's
    rescoring step without the contour walk)."""
    return mask_circularity(otsu_foreground(gray_region))
