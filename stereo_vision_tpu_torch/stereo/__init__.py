"""Dense stereo: block matching (one fused kernel), exact SGBM (cost + SGM
kernels), hierarchical banded SGBM (banded-core kernels, per frame and
batched), LR check, speckle filter, depth."""

from stereo_vision_tpu_torch.stereo.bm import StereoBMParams, stereo_bm
from stereo_vision_tpu_torch.stereo.depth import depth_from_disparity, reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.hier import HIER_FAST, HierParams, stereo_sgbm_hier, stereo_sgbm_hier_batch
from stereo_vision_tpu_torch.stereo.postprocess import left_right_check, speckle_filter
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm

__all__ = [
    "StereoBMParams",
    "stereo_bm",
    "StereoSGBMParams",
    "stereo_sgbm",
    "HierParams",
    "HIER_FAST",
    "stereo_sgbm_hier",
    "stereo_sgbm_hier_batch",
    "reproject_disparity_to_3d",
    "depth_from_disparity",
    "speckle_filter",
    "left_right_check",
]
