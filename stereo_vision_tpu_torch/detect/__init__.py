"""Image-space detectors: checkerboard corners, circles, ball scoring, the
hosted-detector client, and the cv2-replacement image primitives.

Port of ``stereo_vision_tpu/detect``, the hosted client's in-repo
transport (``local_transport``, backed by the port's YOLOv8) included.
"""

from stereo_vision_tpu_torch.detect.ball import (
    BLUE_HSV_RANGE,
    ORANGE_HSV_RANGE,
    BallDetection,
    color_fraction,
    depth_from_apparent_size,
    estimate_focal_length,
    rescore_detections,
)
from stereo_vision_tpu_torch.detect.cache import DetectionCache, image_hash
from stereo_vision_tpu_torch.detect.checkerboard import (
    checkerboard_response,
    find_chessboard_corners,
    harris_response,
    refine_corners_subpix,
)
from stereo_vision_tpu_torch.detect.circles import (
    Circle,
    hough_accumulator,
    hough_circles,
    largest_component_mask,
    mask_circularity,
    min_enclosing_circle,
    otsu_foreground,
    region_circularity,
)
from stereo_vision_tpu_torch.detect.hosted import ROBOFLOW_BLUE_HSV_RANGE, HostedDetectorClient, local_transport
from stereo_vision_tpu_torch.detect.image_ops import (
    binary_dilate,
    binary_erode,
    gaussian_blur,
    in_range,
    otsu_binarize,
    otsu_threshold,
    resize_bilinear,
    rgb_to_gray,
    rgb_to_hsv,
    sobel_magnitude,
)

__all__ = [
    "rgb_to_gray",
    "rgb_to_hsv",
    "gaussian_blur",
    "otsu_threshold",
    "otsu_binarize",
    "in_range",
    "binary_erode",
    "binary_dilate",
    "resize_bilinear",
    "sobel_magnitude",
    "Circle",
    "hough_circles",
    "hough_accumulator",
    "mask_circularity",
    "min_enclosing_circle",
    "region_circularity",
    "largest_component_mask",
    "otsu_foreground",
    "BallDetection",
    "rescore_detections",
    "color_fraction",
    "depth_from_apparent_size",
    "estimate_focal_length",
    "ORANGE_HSV_RANGE",
    "BLUE_HSV_RANGE",
    "harris_response",
    "checkerboard_response",
    "refine_corners_subpix",
    "find_chessboard_corners",
    "DetectionCache",
    "image_hash",
    "HostedDetectorClient",
    "ROBOFLOW_BLUE_HSV_RANGE",
    "local_transport",
]
