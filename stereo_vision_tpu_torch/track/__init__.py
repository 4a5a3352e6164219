"""Temporal analytics: pose fusion, smoothing, constraints, kinematics,
joint angles, ball trajectories and physical validators.

Port of ``stereo_vision_tpu/track``: time is a batch axis on the device
(the Savitzky-Golay taps, the finite-difference kinematics, the angles);
the reference's sequential carries (the EMA landmark filter with the
rolling pose history, the velocity-constraint chain, the One-Euro filter)
are host loops over time whose state stays on the device.
"""

from stereo_vision_tpu_torch.track.angles import angle_3d, pose_angles, pose_angles_dict
from stereo_vision_tpu_torch.track.ball import (
    BallTrajectory,
    analyze_ball_drop,
    drop_report,
    triangulate_detections,
)
from stereo_vision_tpu_torch.track.constraints import (
    apply_anatomical_constraints_sequence,
    apply_bone_length_constraints,
    apply_velocity_constraints,
    average_limb_lengths,
)
from stereo_vision_tpu_torch.track.dual_camera import DualCameraResult, analyze_dual_camera, occlusion_matrix
from stereo_vision_tpu_torch.track.fusion import (
    StereoPoseTracker,
    StereoRig,
    ema_filter,
    extract_key_joints,
    fuse_pose,
)
from stereo_vision_tpu_torch.track.joints import (
    ANGLE_NAMES,
    DEFAULT_LIMB_LENGTHS_MM,
    JOINT_INDEX,
    JOINT_NAMES,
    KEY_JOINTS,
    LIMB_PAIRS,
    NUM_JOINTS,
    pose_array_to_dict,
    pose_dict_to_array,
    sequence_to_array,
    sequence_to_dicts,
)
from stereo_vision_tpu_torch.track.kinematics import (
    GRAVITY_MM_S2,
    detect_start_of_motion,
    estimate_gravity,
    finite_difference,
    joint_accelerations,
    joint_velocities,
    theoretical_drop_velocity,
)
from stereo_vision_tpu_torch.track.smoothing import (
    PRESET_CONFIGS,
    MotionSmoother,
    moving_average_time,
    one_euro_filter_time,
    savgol_coefficients,
    savgol_filter_time,
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
    "KEY_JOINTS",
    "JOINT_NAMES",
    "JOINT_INDEX",
    "NUM_JOINTS",
    "LIMB_PAIRS",
    "DEFAULT_LIMB_LENGTHS_MM",
    "ANGLE_NAMES",
    "pose_dict_to_array",
    "pose_array_to_dict",
    "sequence_to_array",
    "sequence_to_dicts",
    "MotionSmoother",
    "PRESET_CONFIGS",
    "savgol_coefficients",
    "savgol_filter_time",
    "moving_average_time",
    "one_euro_filter_time",
    "average_limb_lengths",
    "apply_anatomical_constraints_sequence",
    "apply_velocity_constraints",
    "apply_bone_length_constraints",
    "GRAVITY_MM_S2",
    "finite_difference",
    "joint_velocities",
    "joint_accelerations",
    "estimate_gravity",
    "detect_start_of_motion",
    "theoretical_drop_velocity",
    "angle_3d",
    "pose_angles",
    "pose_angles_dict",
    "StereoRig",
    "StereoPoseTracker",
    "fuse_pose",
    "ema_filter",
    "extract_key_joints",
    "ValidationResult",
    "validate_baseline",
    "validate_distance",
    "validate_length",
    "validate_sphere_diameter",
    "validate_gravity",
    "BallTrajectory",
    "analyze_ball_drop",
    "triangulate_detections",
    "drop_report",
    "DualCameraResult",
    "analyze_dual_camera",
    "occlusion_matrix",
]
