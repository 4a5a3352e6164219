"""PNG images without OpenCV: 8-bit gray and RGB, non-interlaced.

``read_png`` stands in for ``cv2.imread`` (colour or ``IMREAD_GRAYSCALE``)
and ``write_png`` for ``cv2.imwrite`` of a PNG path, for the CLI's
``disparity`` and ``validate-distance`` and the sync snapshots. The stream
is inflated with the standard library's zlib; the row filters are undone by
the native host runtime (``native.png_unfilter``: all five, Paeth's and
Average's loops in C++), with a Python fallback.

- Reading takes bit depth 8 and colour types 0 (gray) and 2 (RGB);
  anything else (16-bit, palette, alpha, interlaced) raises ``ValueError``. A colour image read as gray takes
  libpng's conversion as ``cv2.imread(IMREAD_GRAYSCALE)`` asks for it
  (weights 0.299 / 0.587 in libpng's 15-bit fixed point, truncated; a
  pixel with R = G = B keeps its value), equal to OpenCV's bit for bit.
- Writing takes (H, W) uint8 (gray) or (H, W, 3) uint8 (RGB), every row
  with filter 0, zlib level 6. The pixels read back bit for bit through
  this reader and through ``cv2.imread`` (an RGB image as OpenCV's BGR).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from stereo_vision_tpu_torch import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> samples a pixel


def _libpng_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(1, 0.299, 0.587)`` on 8-bit RGB: the
    weights 29900 and 58700 (1e-5 units) scaled to 2^15 and truncated,
    blue the rest, the sum shifted right by 15 without rounding."""
    f = rgb.astype(np.uint32)
    rc, gc = 29900 * 32768 // 100000, 58700 * 32768 // 100000
    g = ((rc * f[..., 0] + gc * f[..., 1] + (32768 - rc - gc) * f[..., 2]) >> 15).astype(np.uint8)
    flat = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    return np.where(flat, rgb[..., 0], g)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str | Path, image: np.ndarray) -> Path:
    """Write an (H, W) gray or (H, W, 3) RGB uint8 image as a PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    path = Path(path)
    path.write_bytes(_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                     + _chunk(b"IEND", b""))
    return path


def read_png(path: str | Path, grayscale: bool = False) -> np.ndarray:
    """(H, W) uint8 (a gray file, or any file with ``grayscale``) or (H, W,
    3) uint8 RGB pixels of a PNG file.

    Raises:
      IOError: the file is missing or not a PNG stream.
      ValueError: a PNG this reader does not take (see the module
        docstring).
    """
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise IOError(f"could not read image: {path}") from e
    if not data.startswith(_SIGNATURE):
        raise IOError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise IOError(f"{path}: truncated {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise IOError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, interlace {interlace}: read_png takes "
                         "8-bit gray or RGB, non-interlaced")
    c = _CHANNELS[colour]
    filtered = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = native.png_unfilter(filtered, h, w * c, c).reshape(h, w, c)
    img = px if c == 3 else px[..., 0]
    if grayscale and img.ndim == 3:
        return _libpng_gray(img)
    if not grayscale and img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img)
