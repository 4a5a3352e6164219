"""Neural detectors in torch.nn: a YOLOv8-class object detector and a
33-landmark pose net, with the JAX package's weights carried across.

Port of ``stereo_vision_tpu/models``' serving path; its training (the
losses, ``train.py``, ``pretrained.train_*`` and ``checkpoint.py``) is not
ported yet.
"""

from stereo_vision_tpu_torch.models.convert import convert_ultralytics_state_dict, load_ultralytics_checkpoint
from stereo_vision_tpu_torch.models.layers import SPPF, Bottleneck, C2f, ConvBnSiLU
from stereo_vision_tpu_torch.models.pose import NUM_LANDMARKS, PoseNet, landmarks_to_pixels
from stereo_vision_tpu_torch.models.yolov8 import (
    REG_MAX,
    STRIDES,
    VARIANTS,
    Detections,
    YOLOv8,
    anchor_points,
    decode_predictions,
    detect,
    nms,
)

__all__ = [
    "ConvBnSiLU",
    "Bottleneck",
    "C2f",
    "SPPF",
    "YOLOv8",
    "VARIANTS",
    "STRIDES",
    "REG_MAX",
    "anchor_points",
    "decode_predictions",
    "detect",
    "nms",
    "Detections",
    "PoseNet",
    "NUM_LANDMARKS",
    "landmarks_to_pixels",
    "convert_ultralytics_state_dict",
    "load_ultralytics_checkpoint",
]
