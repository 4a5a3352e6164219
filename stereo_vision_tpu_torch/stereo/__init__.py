"""Dense stereo: exact SGBM (cost + SGM kernels), speckle filter, depth."""
