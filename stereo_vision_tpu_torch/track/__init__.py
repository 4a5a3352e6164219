"""Temporal analytics: kinematics and physical validators.

Port of the JAX package's ``track`` modules ``kinematics`` and
``validators`` (the end of the CLI's ``validate-distance`` chain); its
joints, smoothing, constraints, angles, fusion, ball, dual-camera,
single-camera and pose-pipeline modules are not ported yet.
"""

from stereo_vision_tpu_torch.track.kinematics import (
    GRAVITY_MM_S2,
    detect_start_of_motion,
    estimate_gravity,
    finite_difference,
    joint_accelerations,
    joint_velocities,
    theoretical_drop_velocity,
)
from stereo_vision_tpu_torch.track.validators import (
    ValidationResult,
    validate_baseline,
    validate_distance,
    validate_gravity,
    validate_length,
    validate_sphere_diameter,
)

__all__ = [
    "GRAVITY_MM_S2",
    "finite_difference",
    "joint_velocities",
    "joint_accelerations",
    "estimate_gravity",
    "detect_start_of_motion",
    "theoretical_drop_velocity",
    "ValidationResult",
    "validate_baseline",
    "validate_distance",
    "validate_length",
    "validate_sphere_diameter",
    "validate_gravity",
]
