"""Physical ground-truth validators.

Port of ``stereo_vision_tpu/track/validators.py``: each measurement is
checked against a physically known quantity (camera baseline, object
distance, ruler or square length, sphere diameter, gravity). The checks
are host arithmetic on a few points; tensors are read back first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_vision_tpu_torch.track.kinematics import GRAVITY_MM_S2, estimate_gravity


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ValidationResult(NamedTuple):
    name: str
    measured: float
    expected: float
    error_percent: float
    passed: bool

    @staticmethod
    def make(name: str, measured: float, expected: float, tolerance_percent: float) -> "ValidationResult":
        err = abs(measured - expected) / abs(expected) * 100.0 if expected else float("inf")
        return ValidationResult(name, float(measured), float(expected), err, err <= tolerance_percent)


def validate_baseline(T, actual_distance_mm: float, tolerance_percent: float = 5.0) -> ValidationResult:
    """|T| against the measured camera separation."""
    baseline = float(np.linalg.norm(_host(T)))
    return ValidationResult.make("baseline", baseline, actual_distance_mm, tolerance_percent)


def validate_distance(points_3d, expected_distance_mm: float, tolerance_percent: float = 10.0) -> ValidationResult:
    """Distance to an object: |mean(points_3d)|."""
    d = float(np.linalg.norm(_host(points_3d).reshape(-1, 3).mean(axis=0)))
    return ValidationResult.make("distance", d, expected_distance_mm, tolerance_percent)


def validate_length(
    endpoint_a,
    endpoint_b,
    expected_length_mm: float = 304.8,
    tolerance_percent: float = 10.0,
    name: str = "ruler",
) -> ValidationResult:
    """Length between two triangulated endpoints against a known object
    (a 12 in ruler by default, or a square's side)."""
    L = float(np.linalg.norm(_host(endpoint_a) - _host(endpoint_b)))
    return ValidationResult.make(name, L, expected_length_mm, tolerance_percent)


def validate_sphere_diameter(edge_points_3d, known_circumference_mm: float,
                             tolerance_percent: float = 10.0) -> ValidationResult:
    """Triangulated sphere diameter (the largest distance between edge
    points) against circumference / pi."""
    pts = _host(edge_points_3d).reshape(-1, 3)
    diff = pts[:, None] - pts[None, :]
    measured = float(np.linalg.norm(diff, axis=-1).max())
    expected = known_circumference_mm / np.pi
    return ValidationResult.make("sphere_diameter", measured, expected, tolerance_percent)


def validate_gravity(
    positions_mm,
    timestamps_s,
    tolerance_percent: float = 10.0,
    up_axis: int = 1,
    device=None,
) -> ValidationResult:
    """Measured gravity (:func:`estimate_gravity`'s fit on ``device``)
    against 9800 mm/s^2."""
    g, _ = estimate_gravity(positions_mm, timestamps_s, up_axis=up_axis, device=device)
    return ValidationResult.make("gravity", g, GRAVITY_MM_S2, tolerance_percent)
