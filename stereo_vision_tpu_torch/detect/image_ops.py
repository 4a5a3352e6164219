"""Image primitives: colour conversion, blur, thresholding, morphology,
resize, Sobel.

Port of ``stereo_vision_tpu/detect/image_ops.py`` (the cv2 cvtColor,
GaussianBlur, Otsu threshold, inRange and resize replacements). Every
function takes tensors and runs on their device. Two of them follow the
reference's float32 arithmetic step for step, because their integer
results hang on it:

- :func:`rgb_to_gray` is the fused multiply-add chain XLA makes of the
  reference's 3-tap dot, ``fma(b, .114, fma(g, .587, r * .299))``; a plain
  multiply-add differs in the last bit on many pixels, and a gray level
  that falls under its integer moves its Otsu histogram bin.
  ``torch.addcmul`` rounds each step once, on the CPU and on the card;
- :func:`otsu_threshold` sums its 256 bins in the order of XLA's lowering of
  ``jnp.cumsum`` (16 blocks of 16, each summed left to right, plus the
  running sum of the blocks before it), divides by the pixel count as a
  multiply by its float32 reciprocal and fuses ``mu_t * omega - mu`` into
  one multiply-add, as XLA does (with the plain forms some images get
  another threshold).
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.remap import remap_bilinear

_LUMA_RGB = (0.299, 0.587, 0.114)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device: the float64
    root rounded to float32 (a float64 root of a float32 is never off a
    float32 rounding boundary); the card's float32 root differs from the
    CPU's on some Sobel magnitudes."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) float32 BT.601 gray (cv2 weights)."""
    f = img.to(torch.float32)
    w = torch.tensor(_LUMA_RGB, dtype=torch.float32, device=img.device)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    return torch.addcmul(torch.addcmul(r * w[0], g, w[1]), b, w[2])


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> HSV in cv2's 8-bit ranges (H in [0, 180), S and
    V in [0, 255]), as cv2.cvtColor(BGR2HSV) after a BGR->RGB flip."""
    f = img.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, diff / v.clamp(min=1e-12) * 255.0, 0.0)
    safe = diff.clamp(min=1e-12)
    h = torch.where(
        v == r,
        60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # cv2 8-bit convention
    return torch.stack([h, s, v], dim=-1)


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """cv2.getGaussianKernel-compatible float32 taps."""
    if radius is None:
        radius = int(np.ceil(3.0 * sigma))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _edge_rows(x: torch.Tensor, lo: int, hi: int, axis: int) -> torch.Tensor:
    """``x`` along ``axis`` with its first element repeated ``lo`` times
    before and its last ``hi`` times after (numpy's "edge" padding)."""
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp(0, n - 1)
    return x.index_select(axis, idx)


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) or (H, W, C), replicated borders:
    down the columns, then along the rows, each a sum of shifted slices
    times the float32 taps (elementwise float32 on every device: a
    convolution call could take TF32 on the card).

    ``sigma=0`` derives sigma from ksize as cv2 does:
    sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    radius = ksize // 2
    taps = [float(t) for t in gaussian_kernel_1d(sigma, radius)]
    f = img.to(torch.float32)
    H, W = f.shape[:2]

    def blur1d(x, axis):
        n = x.shape[axis]
        xp = _edge_rows(x, radius, radius, axis)
        out = xp.narrow(axis, 0, n) * taps[-1]  # jnp.convolve flips the taps
        for k in range(1, len(taps)):
            out = out + xp.narrow(axis, k, n) * taps[-1 - k]
        return out

    return blur1d(blur1d(f, 0), 1)


def _scan256(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of 256 float32 values in XLA's order for
    ``jnp.cumsum`` of 256 elements: 16 rows of 16, each summed left to
    right, then each row's sums plus the sum of the totals of the rows
    before it (those totals summed in order)."""
    rows = x.reshape(16, 16)
    cols = [rows[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + rows[:, j])
    scan = torch.stack(cols, dim=1)
    carry = [torch.zeros((), dtype=x.dtype, device=x.device)]
    for i in range(15):
        carry.append(carry[-1] + scan[i, 15])
    return (scan + torch.stack(carry)[:, None]).reshape(256)


def otsu_threshold(img: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of an (H, W) uint8-range image (cv2.threshold with
    THRESH_OTSU): the histogram's between-class variance, argmax over the
    256 levels (the first of equal maxima). Returns a float32 scalar."""
    flat = img.to(torch.int32).reshape(-1).clamp(0, 255)
    hist = torch.zeros(256, dtype=torch.float32, device=img.device)
    hist.index_add_(0, flat.long(), torch.ones(flat.shape, dtype=torch.float32, device=img.device))
    inv_total = torch.tensor(1.0, dtype=torch.float32) / flat.shape[0]
    w = hist * inv_total.to(img.device)
    bins = torch.arange(256, dtype=torch.float32, device=img.device)
    omega = _scan256(w)  # class-0 probability
    mu = _scan256(w * bins)  # class-0 cumulative mean
    mu_t = mu[-1]
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 1e-12, torch.addcmul(-mu, mu_t, omega) ** 2 / denom.clamp(min=1e-12), 0.0)
    return bins[torch.argmax(sigma_b)]


def otsu_binarize(img: torch.Tensor) -> torch.Tensor:
    """(H, W) image -> boolean foreground mask by Otsu (cv2 semantics:
    pixel > threshold)."""
    return img.to(torch.float32) > otsu_threshold(img)


def _pad1(mask: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(mask, (1, 1, 1, 1))


def binary_erode(mask: torch.Tensor) -> torch.Tensor:
    """One round of 4-neighbour binary erosion (cv2.erode, cross kernel)."""
    p = _pad1(mask)
    return p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1] & p[1:-1, :-2] & p[1:-1, 2:]


def binary_dilate(mask: torch.Tensor) -> torch.Tensor:
    """One round of 4-neighbour binary dilation (cv2.dilate, cross kernel)."""
    p = _pad1(mask)
    return p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]


def in_range(img: torch.Tensor, lower, upper) -> torch.Tensor:
    """cv2.inRange: per-channel lower <= img <= upper -> boolean mask."""
    f = img.to(torch.float32)
    lo = torch.as_tensor(np.asarray(lower, np.float32), device=img.device)
    hi = torch.as_tensor(np.asarray(upper, np.float32), device=img.device)
    return ((f >= lo) & (f <= hi)).all(dim=-1)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (H, W[, C]) with cv2's half-pixel mapping; float32."""
    H, W = img.shape[0], img.shape[1]
    ys = (torch.arange(out_h, dtype=torch.float32, device=img.device) + 0.5) * (H / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=img.device) + 0.5) * (W / out_w) - 0.5
    map_y = ys.clamp(0, H - 1)[:, None] * torch.ones((1, out_w), dtype=torch.float32, device=img.device)
    map_x = torch.ones((out_h, 1), dtype=torch.float32, device=img.device) * xs.clamp(0, W - 1)[None, :]
    if img.ndim == 3:  # remap_bilinear takes (..., H, W): channels to the front and back
        return remap_bilinear(img.movedim(-1, 0), map_x, map_y).movedim(0, -1)
    return remap_bilinear(img, map_x, map_y)


def sobel_magnitude(img: torch.Tensor):
    """(magnitude, gx, gy) of the Sobel gradient of an (H, W) image,
    replicated borders (the Hough voting stage's edge strength)."""
    f = img.to(torch.float32)
    pad = _edge_rows(_edge_rows(f, 1, 1, 0), 1, 1, 1)
    gx = (pad[:-2, 2:] + 2 * pad[1:-1, 2:] + pad[2:, 2:]) - (pad[:-2, :-2] + 2 * pad[1:-1, :-2] + pad[2:, :-2])
    gy = (pad[2:, :-2] + 2 * pad[2:, 1:-1] + pad[2:, 2:]) - (pad[:-2, :-2] + 2 * pad[:-2, 1:-1] + pad[:-2, 2:])
    return sqrt32(gx * gx + gy * gy), gx, gy
