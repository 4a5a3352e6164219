"""Camera calibration: intrinsics, stereo extrinsics, frame selection,
quality gates.

Port of ``stereo_vision_tpu/calib``: the cv2.calibrateCamera /
cv2.stereoCalibrate replacements, their Levenberg-Marquardt solves in
float64 on the device (``torch.func.jacfwd`` Jacobians over all frames at
once), the host-side Zhang initialization, diversity-based frame selection
and the pipeline's quality gates.
"""

from stereo_vision_tpu_torch.calib.extrinsics import StereoCalibration, calibrate_stereo
from stereo_vision_tpu_torch.calib.gates import QualityGates, check_intrinsic_quality, check_stereo_quality
from stereo_vision_tpu_torch.calib.intrinsics import CalibrationFlags, CameraCalibration, calibrate_camera
from stereo_vision_tpu_torch.calib.lm import LMResult, levenberg_marquardt
from stereo_vision_tpu_torch.calib.selection import frame_diversity_features, select_diverse_frames
from stereo_vision_tpu_torch.calib.targets import canonical_corner_order, checkerboard_object_points

__all__ = [
    "checkerboard_object_points",
    "canonical_corner_order",
    "levenberg_marquardt",
    "LMResult",
    "calibrate_camera",
    "CameraCalibration",
    "CalibrationFlags",
    "calibrate_stereo",
    "StereoCalibration",
    "frame_diversity_features",
    "select_diverse_frames",
    "QualityGates",
    "check_intrinsic_quality",
    "check_stereo_quality",
]
