"""Detection result cache keyed by image hash.

Port of ``stereo_vision_tpu/detect/cache.py``: detector results memoised
on the MD5 of the image bytes, persisted as a pickle. A tensor is hashed
by its host bytes, so a frame hashes alike on the card and as an array.
A cache written by the JAX package holds its ``BallDetection``; the loader
reads that class as the port's own and raises on any other class of the
JAX package, so that a valid cache is never taken for an empty one and
overwritten. A file that cannot be read or is no pickle starts empty, as
the reference's does.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from stereo_vision_tpu_torch.detect.ball import BallDetection

_REFERENCE_PACKAGE = "stereo_vision_tpu"
_REFERENCE_CLASSES = {("stereo_vision_tpu.detect.ball", "BallDetection"): BallDetection}


def image_hash(image) -> str:
    """MD5 hex digest of the image's C-ordered bytes (a tensor's on the host)."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    return hashlib.md5(np.ascontiguousarray(image).tobytes()).hexdigest()


class _CacheUnpickler(pickle.Unpickler):
    """Reads the JAX package's BallDetection as the port's, without
    importing that package; any other class of it raises ValueError (not
    an UnpicklingError, which would start the cache empty)."""

    def find_class(self, module: str, name: str):
        if (module, name) in _REFERENCE_CLASSES:
            return _REFERENCE_CLASSES[(module, name)]
        if module.split(".")[0] == _REFERENCE_PACKAGE:
            raise ValueError(f"a detection cache may not load {module}.{name}: the file was left as it is")
        return super().find_class(module, name)


class DetectionCache:
    """Persistent {image_hash: result} store."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._cache: dict[str, Any] = {}
        if self.path.exists():
            try:
                with open(self.path, "rb") as f:
                    self._cache = _CacheUnpickler(f).load()
            except (OSError, pickle.UnpicklingError):
                self._cache = {}

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, image) -> Any | None:
        return self._cache.get(image_hash(image))

    def put(self, image, result: Any) -> None:
        self._cache[image_hash(image)] = result

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            pickle.dump(self._cache, f)

    def cached(self, fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        """Wrap a detector so repeat images skip inference."""

        def wrapper(image) -> Any:
            hit = self.get(image)
            if hit is not None:
                return hit
            out = fn(image)
            self.put(image, out)
            return out

        return wrapper
