"""Native host runtime: multi-threaded C++ preprocessing with numpy
fallbacks (grayscale packing, brightness scans) and the frame-window ring
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


def frame_ring_module():
    """The compiled _frame_ring module, or None (callers fall back to a
    queue.Queue path — see io/loader.py)."""
    return _native("frame_ring")


__all__ = [
    "build",
    "load",
    "native_available",
    "pack_gray",
    "brightness_series",
    "frame_ring_module",
]
