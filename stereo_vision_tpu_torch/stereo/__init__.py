"""Dense stereo: exact SGBM (cost + SGM kernels), hierarchical banded SGBM
(banded-core kernels), speckle filter, depth."""
