"""Raster drawing for the overlays and snapshots, without OpenCV.

The JAX package draws its video overlays and sync snapshots with
``cv2.line``, ``cv2.circle``, ``cv2.putText`` and ``cv2.resize``. These are
numpy forms of what those calls draw there, on (H, W[, C]) uint8 frames in
place:

- :func:`draw_line`: a 1-pixel line is 8-connected (Bresenham); a thicker
  one covers the pixels within ``thickness / 2 + 0.45`` of the segment
  (OpenCV's filled rectangle with round caps, its measured width);
- :func:`draw_circle`: filled, the pixels with ``dx^2 + dy^2 <= r^2``
  (OpenCV's filled circle to the pixel); an outline, the pixels within
  ``thickness / 2 + 0.45`` of the circle;
- :func:`put_text`: Hershey's simplex strokes (the font OpenCV's
  ``FONT_HERSHEY_SIMPLEX`` names) for the characters the snapshots label
  with, laid out as OpenCV 4 lays them out (origin at the baseline's left,
  the glyphs' own advances), each stroke a thick line;
- :func:`resize_linear`: ``cv2.resize``'s INTER_LINEAR in fixed point, bit
  for bit (``detect.image_ops.resize_bilinear_u8``).

``tests/test_torch_reporting.py`` holds each against OpenCV by its mean
absolute difference.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.image_ops import resize_bilinear_u8

_RIM = 0.45  # a thick stroke's half-width beyond thickness / 2 (OpenCV's measured width)

# Hershey's simplex glyphs: two letters for the left and right bearings,
# then the strokes' points as letter pairs, each coordinate its letter
# minus "R" (y down, the baseline at 9), strokes apart at " R".
_HERSHEY_SIMPLEX = {
    " ": "JZ",
    "-": "LXNRVR",
    ":": "MWRMQNROSNRM RRVQWRXSWRV",
    "0": "H\\QFNGLJKOKRLWNZQ[S[VZXWYRYOXJVGSFQF",
    "1": "H\\NJPISFS[",
    "2": "H\\LKLJMHNGPFTFVGWHXJXLWNUQK[Y[",
    "3": "H\\MFXFRNUNWOXPYSYUXXVZS[P[MZLYKW",
    "4": "H\\UFKTZT RUFU[",
    "5": "H\\WFMFLOMNPMSMVNXPYSYUXXVZS[P[MZLYKW",
    "6": "H\\XIWGTFRFOGMJLOLTMXOZR[S[VZXXYUYTXQVOSNRNOOMQLT",
    "7": "H\\YFO[ RKFYF",
    "8": "H\\PFMGLILKMMONSOVPXRYTYWXYWZT[P[MZLYKWKTLRNPQOUNWMXKXIWGTFPF",
    "9": "H\\XMWPURRSQSNRLPKMKLLINGQFRFUGWIXMXRWWUZR[P[MZLX",
    "L": "H[LFL[ RL[X[",
    "R": "G\\KFK[ RKFTFWGXHYJYLXNWOTPKP RRPY[",
    "e": "I[LSXSXQWOVNTMQMONMPLSLUMXOZQ[T[VZXX",
    "f": "MYWFUFSGRJR[ ROMVM",
    "g": "I\\XMX]W`VaTbQbOa RXPVNTMQMONMPLSLUMXOZQ[T[VZXX",
    "h": "I\\MFM[ RMQPNRMUMWNXQX[",
    "i": "MWQFRGSFREQF RRMR[",
    "t": "MYRFRWSZU[W[ ROMVM",
}
_BASELINE = 9  # FONT_HERSHEY_SIMPLEX's base line in glyph units


def _color(img: np.ndarray, color) -> np.ndarray:
    """``color``'s first C components for an image of C channels (one for a
    2-D image), as OpenCV takes a Scalar."""
    return np.asarray(color, np.float64).reshape(-1)[: img.shape[2] if img.ndim == 3 else 1].astype(np.uint8)


def _paint(img: np.ndarray, mask: np.ndarray, y0: int, x0: int, color) -> None:
    """Set the pixels of ``mask`` (placed at row y0, column x0, clipped to
    the image) to ``color``."""
    h, w = img.shape[:2]
    mh, mw = mask.shape
    ya, xa, yb, xb = max(y0, 0), max(x0, 0), min(y0 + mh, h), min(x0 + mw, w)
    if ya >= yb or xa >= xb:
        return
    sub = mask[ya - y0:yb - y0, xa - x0:xb - x0]
    img[ya:yb, xa:xb][sub] = _color(img, color)


def _bresenham(p0, p1) -> tuple[np.ndarray, np.ndarray]:
    (x0, y0), (x1, y1) = p0, p1
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err, xs, ys = dx + dy, [], []
    while True:
        xs.append(x0)
        ys.append(y0)
        if x0 == x1 and y0 == y1:
            return np.asarray(ys), np.asarray(xs)
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """A segment between integer points ``p0`` and ``p1`` (x, y) in
    ``color`` (in place; returns ``img``)."""
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    h, w = img.shape[:2]
    if thickness <= 1:
        ys, xs = _bresenham(p0, p1)
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = _color(img, color)
        return img
    r = thickness / 2 + _RIM
    pad = int(np.ceil(r))
    x0, y0 = min(p0[0], p1[0]) - pad, min(p0[1], p1[1]) - pad
    yy, xx = np.mgrid[y0:max(p0[1], p1[1]) + pad + 1, x0:max(p0[0], p1[0]) + pad + 1].astype(np.float64)
    d = np.subtract(p1, p0, dtype=np.float64)
    n = float(d @ d)
    t = np.clip(((xx - p0[0]) * d[0] + (yy - p0[1]) * d[1]) / (n if n else 1.0), 0.0, 1.0)
    _paint(img, (xx - p0[0] - t * d[0]) ** 2 + (yy - p0[1] - t * d[1]) ** 2 <= r * r, y0, x0, color)
    return img


def draw_circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """A circle about the integer point ``center`` (x, y): filled where
    ``thickness`` < 0, else its outline (in place; returns ``img``)."""
    cx, cy, r = int(center[0]), int(center[1]), int(radius)
    pad = r + thickness + 2 if thickness > 0 else r + 1
    yy, xx = np.mgrid[cy - pad:cy + pad + 1, cx - pad:cx + pad + 1]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    if thickness < 0:
        mask = d2 <= r * r
    else:
        mask = np.abs(np.sqrt(d2) - r) <= max(thickness, 1) / 2 + _RIM
    _paint(img, mask, cy - pad, cx - pad, color)
    return img


def put_text(img: np.ndarray, text: str, org, scale: float, color, thickness: int = 1) -> np.ndarray:
    """``text`` with its baseline's left end at ``org`` (x, y), glyph units
    ``scale`` pixels, strokes ``thickness`` wide (in place; returns
    ``img``). A character without a glyph here advances as a space."""
    x = float(org[0])
    y0 = float(org[1]) - _BASELINE * scale
    for c in text:
        glyph = _HERSHEY_SIMPLEX.get(c, "JZ")
        left, right = ord(glyph[0]) - ord("R"), ord(glyph[1]) - ord("R")
        x -= left * scale
        for stroke in glyph[2:].split(" R"):
            pts = [(int(round(x + (ord(stroke[k]) - ord("R")) * scale)),
                    int(round(y0 + (ord(stroke[k + 1]) - ord("R")) * scale))) for k in range(0, len(stroke) - 1, 2)]
            for a, b in zip(pts, pts[1:]):
                draw_line(img, a, b, color, thickness)
        x += right * scale
    return img


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) of an (H, W) or
    (H, W, C) uint8 image, bit for bit, on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    t = t[..., None] if img.ndim == 2 else t
    out = resize_bilinear_u8(t, height, width).numpy()
    return out[..., 0] if img.ndim == 2 else out
