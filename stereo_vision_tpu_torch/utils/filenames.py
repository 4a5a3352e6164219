"""Filename-encoded ground-truth extraction (a copy of
``stereo_vision_tpu/utils/filenames.py``).

Parity with the reference's validation tooling, which encodes the true
object distance in capture filenames (reference:
scripts/archive/analyze_validation.py:28, roboflow_ball_detector.py:338):
e.g. ``ball_2000mm.png``, ``validate_3.5m.mp4``, ``dist_250cm_left.MOV``.
"""

from __future__ import annotations

import re
from pathlib import Path

_PATTERNS = (
    (re.compile(r"(\d+(?:\.\d+)?)\s*mm", re.I), 1.0),
    (re.compile(r"(\d+(?:\.\d+)?)\s*cm", re.I), 10.0),
    (re.compile(r"(\d+(?:\.\d+)?)\s*m(?![a-z])", re.I), 1000.0),
)


def extract_distance_from_filename(path: str | Path) -> float | None:
    """Distance in mm encoded in a filename, or None.

    Recognizes mm/cm/m suffixes; a bare trailing number is treated as
    meters when < 100 (the reference's convention for e.g. ``2.5.mp4``).
    """
    stem = Path(path).stem
    for pat, scale in _PATTERNS:
        m = pat.search(stem)
        if m:
            return float(m.group(1)) * scale
    m = re.search(r"(\d+(?:\.\d+)?)$", stem)
    if m:
        v = float(m.group(1))
        if v < 100:
            return v * 1000.0
    return None
