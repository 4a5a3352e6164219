"""Batched stereo-stream processing: (B, H, W) raw pairs -> disparity -> 3D.

Port of ``stereo_vision_tpu/parallel/streaming.py::batched_stereo_pipeline``
and ``_frame_stats`` for its three matchers: block matching (``"bm"``), the
exact SGBM (``"sgbm"``) and the hierarchical one (``"sgbm_hier"``). The
batch of frames runs through one set of kernel launches (frames on the CUDA
grid, not a Python loop).

``make_sharded_pipeline`` and ``StereoStreamProcessor`` are the single-card
forms of the reference's: the closure moves the maps and Q to the card once,
and the processor double-buffers the host->device upload (pinned staging
buffers and a copy stream) under the current window's compute. A mesh of
more than one device is ROADMAP A.8; ``stream_video_pair`` is A.9.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.ops.remap import make_remap
from stereo_vision_tpu_torch.parallel.mesh import Mesh, single_device
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
    """``a`` as a ``dtype`` tensor on ``device``: moved in its own dtype,
    then converted there (one ``.to`` with both converts a host array on the
    host, and a uint8 frame then crosses the bus as 4 bytes a pixel)."""
    return torch.as_tensor(a).to(device).to(dtype)


def _check_matcher(matcher: str, params) -> None:
    if matcher not in ("bm", "sgbm", "sgbm_hier"):
        raise ValueError(f"unknown matcher: {matcher}")
    want = StereoBMParams if matcher == "bm" else StereoSGBMParams
    if params is not None and not isinstance(params, want):
        raise TypeError(f"matcher={matcher!r} takes {want.__name__} params, got {type(params).__name__}")


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
    16: HIER8_FAST, 32: HIER4_FAST, else the band-32 default); the other
    matchers ignore ``hier_params``, as the reference does. With
    ``stats_only`` it returns the (B, 2) per-frame [valid_fraction,
    median_depth] instead.

    Inputs may be numpy arrays or tensors; they are moved to ``device``
    (None = the CUDA card; raises when there is none). Maps and Q are used
    as float32.
    """
    _check_matcher(matcher, params)
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


def _mesh_device(mesh: Mesh) -> torch.device:
    """The one device of a 1x1 mesh; a larger mesh is refused."""
    return single_device(mesh, "the multi-device pipeline")


def make_sharded_pipeline(
    mesh: Mesh,
    maps,
    Q,
    matcher: str = "sgbm",
    params: StereoBMParams | StereoSGBMParams | None = None,
    hier_params=None,
    stats_only: bool = False,
) -> Callable:
    """``run(left, right)`` running :func:`batched_stereo_pipeline` on the
    mesh's device with ``maps`` and ``Q`` moved there once, as float32, now.

    ``run`` takes (B, H, W) numpy arrays or tensors, uploads them and
    returns the device tensors (disparity, points), or the (B, 2) stats
    with ``stats_only``, without synchronising. ``sgbm_hier`` needs B ==
    128 // band, as the batched pipeline does. Only a 1x1 mesh runs: a
    larger one raises ``NotImplementedError`` before any work.
    """
    dev = _mesh_device(mesh)
    _check_matcher(matcher, params)
    mx1, my1, mx2, my2 = (_to(m, dev, torch.float32) for m in maps)
    Qd = _to(Q, dev, torch.float32)

    def run(left, right):
        return batched_stereo_pipeline(left, right, (mx1, my1, mx2, my2), Qd, matcher, params, hier_params,
                                       stats_only, device=dev)

    return run


class StereoStreamProcessor:
    """Double-buffered host->device streaming around the pipeline of
    :func:`make_sharded_pipeline`.

    ``submit`` enqueues a window and then waits for the one submitted
    before it; ``drain`` waits for and returns the last submitted window
    (an earlier one, waited on by ``submit``, is dropped), as the
    reference's processor does. On the card each side's frames go through
    two alternating pinned staging buffers, uploaded on a side copy stream
    that the compute stream (the current stream at ``submit``) waits on, so
    the next window's upload overlaps the current window's kernels. On the
    CPU the window is copied and computed in ``submit``. Either way the
    processor holds its own copy of the caller's arrays once ``submit``
    returns.
    """

    def __init__(self, mesh: Mesh, maps, Q, matcher: str = "sgbm", params=None, hier_params=None):
        self.mesh = mesh
        self.device = _mesh_device(mesh)
        self._fn = make_sharded_pipeline(mesh, maps, Q, matcher, params, hier_params)
        self._pending = None  # (disparity, points, event or None)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._staging: list[tuple | None] = [None, None]  # per slot: (left, right, upload event)
            self._slot = 0

    def _stage(self, left, right) -> tuple[torch.Tensor, torch.Tensor, torch.cuda.Event]:
        """Copy the window into the next pinned slot and upload it on the
        copy stream; returns the device tensors and the upload's event."""
        left, right = (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
                       for a in (left, right))
        slot = self._staging[self._slot]
        if slot is not None:
            slot[2].synchronize()  # the slot's previous upload has read it
        if slot is None or any(b.shape != a.shape or b.dtype != a.dtype for b, a in zip(slot[:2], (left, right))):
            slot = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in (left, right))
        pl, pr = slot[0], slot[1]
        pl.copy_(left)
        pr.copy_(right)
        event = torch.cuda.Event()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dl = pl.to(self.device, non_blocking=True)
            dr = pr.to(self.device, non_blocking=True)
            event.record(self._copy_stream)
        # The inputs were allocated on the copy stream: keep their memory
        # from reuse until the compute stream's work on them is done.
        dl.record_stream(compute)
        dr.record_stream(compute)
        self._staging[self._slot] = (pl, pr, event)
        self._slot ^= 1
        return dl, dr, event

    def submit(self, left, right) -> None:
        """Enqueue a (B, H, W) window, then wait for the previous one."""
        if self._cuda:
            dl, dr, uploaded = self._stage(left, right)
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(uploaded)
            disp, pts = self._fn(dl, dr)
            done = torch.cuda.Event()
            done.record(compute)
        else:
            disp, pts = self._fn(*(a.clone() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
                                   for a in (left, right)))
            done = None
        prev, self._pending = self._pending, (disp, pts, done)
        # Keep at most one window in flight beyond the current one.
        if prev is not None and prev[2] is not None:
            prev[2].synchronize()

    def drain(self):
        """Wait for and return the last submitted window's (disparity,
        points) as numpy arrays, or None when nothing is pending."""
        if self._pending is None:
            return None
        disp, pts, done = self._pending
        if done is not None:
            done.synchronize()
        self._pending = None
        return disp.cpu().numpy(), pts.cpu().numpy()
