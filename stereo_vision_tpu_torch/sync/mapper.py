"""Persisted-offset stereo frame mapper.

Port of ``stereo_vision_tpu/sync/mapper.py``: once an offset is known (flash,
content or timestamps), map left frame indices to right ones, iterate
aligned pairs, and persist or reload the mapping as JSON (the same file
format as the reference's, so files move between the two).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator


class StereoFrameMapper:
    """left index <-> right index mapping for a fixed integer offset."""

    def __init__(self, offset: int, left_count: int | None = None, right_count: int | None = None):
        self.offset = int(offset)  # right = left + offset
        self.left_count = left_count
        self.right_count = right_count

    def left_to_right(self, left_idx: int) -> int | None:
        """The right index of a left one; None when out of range."""
        r = left_idx + self.offset
        if r < 0 or (self.right_count is not None and r >= self.right_count):
            return None
        return r

    def right_to_left(self, right_idx: int) -> int | None:
        l = right_idx - self.offset
        if l < 0 or (self.left_count is not None and l >= self.left_count):
            return None
        return l

    def valid_range(self) -> tuple[int, int]:
        """Left-index range [start, stop) with a valid right partner."""
        start = max(0, -self.offset)
        stop_candidates = []
        if self.left_count is not None:
            stop_candidates.append(self.left_count)
        if self.right_count is not None:
            stop_candidates.append(self.right_count - self.offset)
        stop = min(stop_candidates) if stop_candidates else start
        return start, max(stop, start)

    def pairs(self) -> Iterator[tuple[int, int]]:
        """Aligned (left, right) index pairs."""
        start, stop = self.valid_range()
        for l in range(start, stop):
            yield l, l + self.offset

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps({"offset": self.offset, "left_count": self.left_count, "right_count": self.right_count})
        )

    @classmethod
    def load(cls, path: str | Path) -> "StereoFrameMapper":
        d = json.loads(Path(path).read_text())
        return cls(d["offset"], d.get("left_count"), d.get("right_count"))
