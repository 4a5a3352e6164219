"""Neural detectors in torch.nn: a YOLOv8-class object detector and a
33-landmark pose net, their losses and their training, with the JAX
package's weights carried across.

Port of ``stereo_vision_tpu/models``; its ``checkpoint.py`` writes a
format of the port's own (the card's machine has no orbax).
"""

from stereo_vision_tpu_torch.models.convert import convert_ultralytics_state_dict, load_ultralytics_checkpoint
from stereo_vision_tpu_torch.models.layers import SPPF, Bottleneck, C2f, ConvBnSiLU
from stereo_vision_tpu_torch.models.pose import NUM_LANDMARKS, PoseNet, landmarks_to_pixels, pose_loss
from stereo_vision_tpu_torch.models.train import TrainState, make_train_step, put_batch, shard_variables
from stereo_vision_tpu_torch.models.yolov8 import (
    REG_MAX,
    STRIDES,
    VARIANTS,
    Detections,
    YOLOv8,
    anchor_points,
    decode_predictions,
    detect,
    detection_loss,
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
    "detection_loss",
    "PoseNet",
    "NUM_LANDMARKS",
    "pose_loss",
    "landmarks_to_pixels",
    "convert_ultralytics_state_dict",
    "load_ultralytics_checkpoint",
    "TrainState",
    "make_train_step",
    "shard_variables",
    "put_batch",
]
