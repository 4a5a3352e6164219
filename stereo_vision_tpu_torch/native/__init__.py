"""Native host runtime: multi-threaded C++ preprocessing with numpy
fallbacks (grayscale packing, brightness scans, PNG's row filters) and the frame-window ring
that feeds the card's staging (``io/loader.py``). The port's copy of
``stereo_vision_tpu/native``: the same sources and the same fallbacks,
built by :mod:`.build` on first use, never on import."""

from __future__ import annotations

import numpy as np

from stereo_vision_tpu_torch.native.build import build, load

_mods: dict = {}


def _native(name: str = "host_ops"):
    if name not in _mods:
        _mods[name] = load(name)
    return _mods[name]


def native_available(name: str = "host_ops") -> bool:
    return _native(name) is not None


def pack_gray(frames_rgb: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB -> (T, H, W) uint8 BT.601 grayscale in 8.8
    fixed point, ``(77 R + 150 G + 29 B + 128) >> 8``.

    C++/OpenMP when available; numpy otherwise, bit for bit the same. It
    is not ``cv2.cvtColor``'s rule, which ``io.video.rgb_to_gray`` follows.
    """
    frames_rgb = np.ascontiguousarray(frames_rgb, np.uint8)
    t, h, w, _ = frames_rgb.shape
    m = _native()
    if m is not None:
        raw = m.pack_gray(frames_rgb)
        return np.frombuffer(raw, np.uint8).reshape(t, h, w).copy()
    f = frames_rgb.astype(np.uint32)
    g = (77 * f[..., 0] + 150 * f[..., 1] + 29 * f[..., 2] + 128) >> 8
    return g.astype(np.uint8)


def brightness_series(frames: np.ndarray) -> np.ndarray:
    """(T, H, W[, 3]) uint8 -> (T,) float64 mean brightness (the host path
    of ``sync.flash.frame_brightness``, for frames not yet on the card)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    m = _native()
    if m is not None:
        raw = m.brightness_series(frames)
        return np.frombuffer(raw, np.float64).copy()
    if frames.ndim == 4:
        return pack_gray(frames).mean(axis=(1, 2)).astype(np.float64)
    return frames.mean(axis=(1, 2)).astype(np.float64)


def png_unfilter(filtered: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """A PNG image's inflated scanlines (``rows`` of a filter-type byte and
    ``stride`` bytes, uint8) -> (rows, stride) uint8 pixels, each row's
    filter undone (None, Sub, Up, Average, Paeth; ``bpp`` bytes a pixel).

    C++ when available; a Python loop otherwise (Average and Paeth are
    sequential along a row), the same bytes.

    Raises:
      ValueError: a filter type above 4, or too few bytes.
    """
    filtered = np.ascontiguousarray(filtered, np.uint8).reshape(-1)
    m = _native()
    if m is not None and hasattr(m, "png_unfilter"):
        return np.frombuffer(m.png_unfilter(filtered, rows, stride, bpp), np.uint8).reshape(rows, stride).copy()
    if filtered.size < rows * (stride + 1):
        raise ValueError("png_unfilter: the data is shorter than rows x (stride + 1)")
    lines = filtered[: rows * (stride + 1)].reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(rows):
        kind, raw = int(lines[y, 0]), lines[y, 1:].astype(np.int64)
        if kind == 0:
            row = raw
        elif kind == 1:
            row = np.cumsum(raw.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:
            row = (raw + prev) % 256
        elif kind in (3, 4):
            r, up = raw.tolist(), prev.tolist()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                b, c = up[i], (up[i - bpp] if i >= bpp else 0)
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                r[i] = (r[i] + pred) & 255
            row = np.asarray(r, np.int64)
        else:
            raise ValueError(f"png_unfilter: unknown filter type {kind}")
        out[y] = row
        prev = row
    return out


def frame_ring_module():
    """The compiled _frame_ring module, or None (callers fall back to a
    queue.Queue path — see io/loader.py)."""
    return _native("frame_ring")


def frame_ring_totals() -> tuple[int, int, int, int]:
    """(put_wait_ns, puts, get_wait_ns, gets) summed over every native ring
    since the module loaded; zeros where it is not loaded (nothing is built
    for this)."""
    m = _mods.get("frame_ring")
    return (0, 0, 0, 0) if m is None else tuple(m.ring_totals())


__all__ = [
    "build",
    "load",
    "native_available",
    "pack_gray",
    "brightness_series",
    "png_unfilter",
    "frame_ring_module",
    "frame_ring_totals",
]
