"""Checkerboard calibration targets: object-point grids and corner-order
canonicalization.

Port of ``stereo_vision_tpu/calib/targets.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor


def checkerboard_object_points(cols: int, rows: int, square_size: float, device=None) -> torch.Tensor:
    """(cols*rows, 3) float32 planar grid of inner-corner positions, z = 0,
    on ``device`` (None = the CUDA card).

    Ordering matches cv2.findChessboardCorners: row-major, x fastest. The
    board is always an explicit argument (the reference's scripts drift
    between 7x4, 9x7 and 9x6 boards and 25-100 mm squares).
    """
    g = np.zeros((rows * cols, 3), np.float32)
    g[:, :2] = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2)
    return as_tensor(g * np.float32(square_size), device)


def canonical_corner_order(corners, cols: int, rows: int, device=None) -> torch.Tensor:
    """Flip a detected (N, 2) corner grid (N = cols*rows, detector order) so
    corner 0 is top-left and rows scan left to right: vertically if the
    first row is below the last, then horizontally if the first column is
    right of the last."""
    g = as_tensor(corners, device).reshape(rows, cols, 2)
    g = torch.where(g[0, 0, 1] > g[-1, 0, 1], g.flip(0), g)
    g = torch.where(g[0, 0, 0] > g[0, -1, 0], g.flip(1), g)
    return g.reshape(-1, 2)
