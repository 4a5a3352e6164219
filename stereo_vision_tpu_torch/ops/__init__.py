"""Geometry and image primitives: rotation, distortion, rectification,
triangulation, bilinear remap."""

from stereo_vision_tpu_torch.ops.distortion import (
    distort_normalized,
    project_points,
    undistort_normalized,
    undistort_points,
)
from stereo_vision_tpu_torch.ops.rectify import RectifyResult, init_undistort_rectify_map, stereo_rectify
from stereo_vision_tpu_torch.ops.remap import make_remap, remap_bilinear
from stereo_vision_tpu_torch.ops.rotation import euler_angles_from_matrix, rodrigues, rodrigues_inv
from stereo_vision_tpu_torch.ops.triangulate import (
    project_homogeneous,
    reprojection_error,
    triangulate_normalized,
    triangulate_points,
)

__all__ = [
    "rodrigues",
    "rodrigues_inv",
    "euler_angles_from_matrix",
    "distort_normalized",
    "project_points",
    "undistort_normalized",
    "undistort_points",
    "RectifyResult",
    "stereo_rectify",
    "init_undistort_rectify_map",
    "remap_bilinear",
    "make_remap",
    "triangulate_points",
    "triangulate_normalized",
    "project_homogeneous",
    "reprojection_error",
]
