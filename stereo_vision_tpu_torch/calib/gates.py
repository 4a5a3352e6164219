"""Calibration quality gates.

Port of ``stereo_vision_tpu/calib/gates.py``: the thresholds the
reference's pipeline driver enforces between stages (reprojection error
> 1.0 px fails, > 0.5 px warns; per-pair RMS < 2.0).
"""

from __future__ import annotations

import dataclasses
import enum


class GateStatus(enum.Enum):
    PASS = "pass"
    WARN = "warn"
    FAIL = "fail"


@dataclasses.dataclass(frozen=True)
class QualityGates:
    fail_px: float = 1.0
    warn_px: float = 0.5
    max_pair_rms: float = 2.0
    min_frames: int = 10
    min_pairs: int = 5


def check_intrinsic_quality(rms: float, n_frames: int, gates: QualityGates = QualityGates()) -> GateStatus:
    if n_frames < gates.min_frames or rms > gates.fail_px:
        return GateStatus.FAIL
    if rms > gates.warn_px:
        return GateStatus.WARN
    return GateStatus.PASS


def check_stereo_quality(
    rms: float,
    n_pairs: int,
    baseline_error_pct: float | None = None,
    gates: QualityGates = QualityGates(),
) -> GateStatus:
    if n_pairs < gates.min_pairs or rms > gates.fail_px:
        return GateStatus.FAIL
    if rms > gates.warn_px or (baseline_error_pct is not None and baseline_error_pct > 5.0):
        return GateStatus.WARN
    return GateStatus.PASS
