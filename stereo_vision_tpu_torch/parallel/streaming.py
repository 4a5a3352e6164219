"""Batched stereo-stream processing: (B, H, W) raw pairs -> disparity -> 3D.

Port of ``stereo_vision_tpu/parallel/streaming.py::batched_stereo_pipeline``
and ``_frame_stats`` for its three matchers: block matching (``"bm"``), the
exact SGBM (``"sgbm"``) and the hierarchical one (``"sgbm_hier"``). The
batch of frames runs through one set of kernel launches (frames on the CUDA
grid, not a Python loop). Mesh sharding, ``make_sharded_pipeline``,
``StereoStreamProcessor`` and ``stream_video_pair`` belong to later slices
of the port.
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.remap import make_remap
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams, stereo_bm
from stereo_vision_tpu_torch.stereo.depth import reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.hier import HIER4_FAST, HIER8_FAST, HIER_FAST, HierParams, stereo_sgbm_hier_batch
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm


def _frame_stats(disp: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, H, W) disparity + (B, H, W, 3) points -> (B, 2) per-frame
    [valid_fraction, median_depth], d == 0 excluded from validity.

    The median of an even count averages the two middle values, as
    ``jnp.nanmedian`` does (``torch.nanmedian`` would return the lower)."""
    B = disp.shape[0]
    valid = (disp > 0).reshape(B, -1)
    vf = valid.to(torch.float32).mean(dim=1)
    z = pts[..., 2].reshape(B, -1)
    keep = valid & ~torch.isnan(z)
    z, _ = torch.sort(torch.where(keep, z, float("inf")), dim=1)
    n = keep.sum(dim=1)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    zl = torch.gather(z, 1, lo[:, None])[:, 0]
    zh = torch.gather(z, 1, hi[:, None])[:, 0]
    med = torch.where(n > 0, (zl + zh) * 0.5, float("nan"))
    return torch.stack([vf, med], dim=-1)


def _to(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def batched_stereo_pipeline(
    left,
    right,
    maps,
    Q,
    matcher: str = "sgbm",
    params: StereoBMParams | StereoSGBMParams | None = None,
    hier_params=None,
    stats_only: bool = False,
    device: str | torch.device | None = None,
):
    """(B, H, W) raw pairs -> (disparity (B, H, W), points3d (B, H, W, 3)).

    Remaps both views with the rectification ``maps`` (mx1, my1, mx2, my2),
    rounds to integer intensities, runs the matcher and reprojects through
    ``Q``. ``matcher="bm"`` is block matching (``params``: a
    :class:`StereoBMParams`); ``"sgbm"`` the exact 8-path SGBM; ``"sgbm_hier"`` the
    hierarchical banded one, which needs B == 128 // band frames: without
    ``hier_params`` the preset follows the batch size (8: HIER_FAST,
    16: HIER8_FAST, 32: HIER4_FAST, else the band-32 default). With
    ``stats_only`` it returns the (B, 2) per-frame [valid_fraction,
    median_depth] instead.

    Inputs may be numpy arrays or tensors; they are moved to ``device``
    (None = the CUDA card; raises when there is none). Maps and Q are used
    as float32.
    """
    if matcher not in ("bm", "sgbm", "sgbm_hier"):
        raise ValueError(f"unknown matcher: {matcher}")
    want = StereoBMParams if matcher == "bm" else StereoSGBMParams
    if params is not None and not isinstance(params, want):
        raise TypeError(f"matcher={matcher!r} takes {want.__name__} params, got {type(params).__name__}")
    if hier_params is not None and matcher != "sgbm_hier":
        raise ValueError("hier_params applies only to matcher='sgbm_hier'")
    dev = resolve_device(device)
    mx1, my1, mx2, my2 = (_to(m, dev, torch.float32) for m in maps)
    Q = _to(Q, dev, torch.float32)
    remap_l = make_remap(mx1, my1)
    remap_r = make_remap(mx2, my2)

    # Round to integer intensities (cv2 remaps uint8 -> uint8) before the
    # integer-cost matcher; torch.round is half-to-even like jnp.round.
    lr = torch.round(remap_l(_to(left, dev, torch.float32))).to(torch.int32)
    rr = torch.round(remap_r(_to(right, dev, torch.float32))).to(torch.int32)
    if matcher == "sgbm_hier":
        if hier_params is None:
            hier_params = {8: HIER_FAST, 16: HIER8_FAST, 32: HIER4_FAST}.get(lr.shape[0], HierParams())
        disp = stereo_sgbm_hier_batch(lr, rr, params or StereoSGBMParams(), hier_params)
    elif matcher == "bm":
        disp = stereo_bm(lr, rr, params or StereoBMParams())
    else:
        disp = stereo_sgbm(lr, rr, params or StereoSGBMParams())
    pts = reproject_disparity_to_3d(disp, Q)
    if stats_only:
        return _frame_stats(disp, pts)
    return disp, pts
