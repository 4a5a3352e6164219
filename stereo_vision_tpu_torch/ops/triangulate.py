"""Sparse 3D triangulation (DLT) and reprojection error.

Port of ``stereo_vision_tpu/ops/triangulate.py`` (``cv2.triangulatePoints``
for finite points, batched over any leading axes). Each point's 4x4 DLT
system is row-normalised by the norm of its XYZ columns and solved as the
inhomogeneous 3x3 normal equations (not an SVD), as the reference does.
The products are written out elementwise (:func:`.rotation.mm`) in the
inputs' dtype; the batched 3x3 solve is ``torch.linalg.solve``.
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.ops.rotation import as_float_tensors, mm, mv


def triangulate_points(P1, P2, pts1, pts2, device=None) -> torch.Tensor:
    """(3, 4) pixel projection matrices and (..., 2) matched pixels ->
    (..., 3) points in the frame of P1."""
    P1, P2, pts1, pts2 = as_float_tensors(P1, P2, pts1, pts2, device=device)
    x1, y1 = pts1[..., 0:1], pts1[..., 1:2]
    x2, y2 = pts2[..., 0:1], pts2[..., 1:2]
    # Rows of the DLT system: x * P[2] - P[0], y * P[2] - P[1] per camera.
    A = torch.stack([x1 * P1[2] - P1[0], y1 * P1[2] - P1[1], x2 * P2[2] - P2[0], y2 * P2[2] - P2[1]], dim=-2)
    A = A / torch.clamp(torch.linalg.vector_norm(A[..., :3], dim=-1, keepdim=True), min=1e-12)
    M, b = A[..., :3], -A[..., 3]
    MtM = mm(M.transpose(-1, -2), M)
    Mtb = (M * b.unsqueeze(-1)).sum(-2)
    return torch.linalg.solve(MtM, Mtb.unsqueeze(-1))[..., 0]


def triangulate_normalized(R, T, xy1, xy2, device=None) -> torch.Tensor:
    """Triangulation from undistorted normalised coordinates of a rig with
    stereo rotation ``R`` and translation ``T``: P1 = [I | 0], P2 = [R | T]."""
    R, T, xy1, xy2 = as_float_tensors(R, T, xy1, xy2, device=device)
    R = R.reshape(3, 3)
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device), torch.zeros_like(R[:, :1])], dim=1)
    P2 = torch.cat([R, T.reshape(3, 1)], dim=1)
    return triangulate_points(P1, P2, xy1, xy2)


def project_homogeneous(P, X, device=None) -> torch.Tensor:
    """(..., 3) points through a (3, 4) matrix -> (..., 2) pixels."""
    P, X = as_float_tensors(P, X, device=device)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    uvw = mv(P, Xh)
    return uvw[..., :2] / uvw[..., 2:3]


def reprojection_error(P1, P2, X, pts1, pts2, device=None) -> torch.Tensor:
    """Per-point mean of the two cameras' Euclidean reprojection errors, in
    pixels."""
    P1, P2, X, pts1, pts2 = as_float_tensors(P1, P2, X, pts1, pts2, device=device)
    e1 = torch.linalg.vector_norm(project_homogeneous(P1, X) - pts1, dim=-1)
    e2 = torch.linalg.vector_norm(project_homogeneous(P2, X) - pts2, dim=-1)
    return 0.5 * (e1 + e2)
