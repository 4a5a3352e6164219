"""Dense stereo: block matching (one fused kernel), exact SGBM (cost + SGM
kernels), hierarchical banded SGBM (banded-core kernels), LR check, speckle
filter, depth."""
