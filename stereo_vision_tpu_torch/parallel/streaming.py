"""Batched stereo-stream processing: (B, H, W) raw pairs -> disparity -> 3D.

Port of ``stereo_vision_tpu/parallel/streaming.py::batched_stereo_pipeline``
and ``_frame_stats`` for its three matchers: block matching (``"bm"``), the
exact SGBM (``"sgbm"``) and the hierarchical one (``"sgbm_hier"``). The
batch of frames runs through one set of kernel launches (frames on the CUDA
grid, not a Python loop).

``make_sharded_pipeline`` and ``StereoStreamProcessor`` are the reference's
on a mesh of N devices (``parallel.mesh``): frames split over ``data``, each
data device holding its own copy of the maps and Q, moved there once, and
running the batched pipeline on its frames; the processor double-buffers
each device's host->device upload (pinned staging buffers and a copy
stream) under the current window's compute. One host thread drives every
device, as the JAX package's single program does.

``stream_video_pair`` streams two video files to disparity and 3D: decode
and the native gray pack on host threads (``io.loader.StereoPairLoader``),
each window's upload through the processor's pinned staging, the batched
pipeline on the mesh, and each window's read-back into pinned host memory
on a side stream, so that the host decodes window k + 2 while the card runs
window k + 1 and returns window k.
"""

from __future__ import annotations

import collections
from typing import Callable

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.io.loader import StereoPairLoader
from stereo_vision_tpu_torch.ops.remap import make_remap
from stereo_vision_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, concat_on, on_device, split_along
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams, stereo_bm
from stereo_vision_tpu_torch.stereo.depth import reproject_disparity_to_3d
from stereo_vision_tpu_torch.stereo.hier import HIER4_FAST, HIER8_FAST, HIER_FAST, HierParams, stereo_sgbm_hier_batch
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, stereo_sgbm
from stereo_vision_tpu_torch.utils.profiling import span


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


def _device_part(dev: torch.device, maps, Q, matcher: str, params, hier_params, stats_only: bool) -> Callable:
    """``run(left, right)``: :func:`batched_stereo_pipeline` on ``dev`` (made
    the current device for its kernels) with ``maps`` and ``Q`` moved there
    once, as float32, now."""
    mx1, my1, mx2, my2 = (_to(m, dev, torch.float32) for m in maps)
    Qd = _to(Q, dev, torch.float32)

    def run(left, right):
        with on_device(dev):
            return batched_stereo_pipeline(left, right, (mx1, my1, mx2, my2), Qd, matcher, params, hier_params,
                                           stats_only, device=dev)

    return run


def make_sharded_pipeline(
    mesh: Mesh,
    maps,
    Q,
    matcher: str = "sgbm",
    params: StereoBMParams | StereoSGBMParams | None = None,
    hier_params=None,
    stats_only: bool = False,
) -> Callable:
    """``run(left, right)`` running :func:`batched_stereo_pipeline` data
    parallel over the mesh's ``data`` axis: each data device holds its own
    float32 copy of ``maps`` and ``Q``, moved there once, now, and runs the
    pipeline on its share of the frames on its own current stream. ``space``
    is not used (the devices along it are not given the frames twice).

    ``run`` takes (B, H, W) numpy arrays, tensors or :class:`.mesh.ShardedTensor`
    (a batch split over ``data`` is taken shard by shard); B must divide by
    the data axis's size (ValueError). It returns (disparity, points), or
    the (B, 2) stats with ``stats_only``, gathered on the mesh's first
    device, without synchronising. ``sgbm_hier`` needs 128 // band frames a
    device, each device's pack run as the batched pipeline runs it (without
    ``hier_params`` the preset follows the frames a device).
    """
    _check_matcher(matcher, params)
    devices = mesh.axis_devices(DATA_AXIS)
    parts = [_device_part(d, maps, Q, matcher, params, hier_params, stats_only) for d in devices]
    if len(parts) == 1:
        return parts[0]
    first = mesh.first

    def run(left, right):
        pieces = zip(split_along(left, mesh, DATA_AXIS), split_along(right, mesh, DATA_AXIS))
        return concat_on([part(lp, rp) for part, (lp, rp) in zip(parts, pieces)], first)

    return run


def _host_pieces(a, n: int) -> list[torch.Tensor]:
    """A host window (numpy array or tensor) in ``n`` equal pieces along the
    batch, as host tensors sharing its memory."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if t.shape[0] % n:
        raise ValueError(f"a window of {t.shape[0]} frames must be divisible by the {n} devices of 'data'")
    return list(t.chunk(n)) if n > 1 else [t]


class _Staging:
    """One data device's upload path: two alternating pinned (left, right)
    slots and a side copy stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy_stream = torch.cuda.Stream(device)
        self.slots: list[tuple | None] = [None, None]  # per slot: (left, right, upload event)
        self.slot = 0

    def put(self, left: torch.Tensor, right: torch.Tensor, seq: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.cuda.Event]:
        """Copy the pieces into the next pinned slot and upload them on the
        copy stream; returns the device tensors and the upload's event. The
        whole put is a ``staging.put`` span of window ``seq``, the wait for
        the slot ``staging.slot_wait`` and the copy ``staging.copy``."""
        with span("staging.put", seq):
            slot = self.slots[self.slot]
            if slot is not None:
                with span("staging.slot_wait", seq):
                    slot[2].synchronize()  # the slot's previous upload has read it
            if slot is None or any(b.shape != a.shape or b.dtype != a.dtype for b, a in zip(slot[:2], (left, right))):
                slot = tuple(torch.empty(a.shape, dtype=a.dtype, pin_memory=True) for a in (left, right))
            pl, pr = slot[0], slot[1]
            with span("staging.copy", seq):
                pl.copy_(left)
                pr.copy_(right)
            event = torch.cuda.Event()
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                dl = pl.to(self.device, non_blocking=True)
                dr = pr.to(self.device, non_blocking=True)
                event.record(self.copy_stream)
            # The inputs were allocated on the copy stream: keep their memory
            # from reuse until the compute stream's work on them is done.
            dl.record_stream(compute)
            dr.record_stream(compute)
            self.slots[self.slot] = (pl, pr, event)
            self.slot ^= 1
            return dl, dr, event


def _enqueue(parts: list, devices: list, staging: list | None, left, right, seq: int | None = None) -> list[tuple]:
    """Run a host window's shares on the data devices: per device, its
    part's output and an event recorded after it (None on the CPU). On the
    card each share goes through its device's pinned staging and the
    device's compute stream waits for its upload; on the CPU a share runs
    at once, on a copy of the caller's frames. Each part's call is a
    ``stream.launch`` span of window ``seq``."""
    n = len(devices)
    pending = []
    for i, (part, dev, (lp, rp)) in enumerate(zip(parts, devices, zip(_host_pieces(left, n),
                                                                      _host_pieces(right, n)))):
        if staging is not None:
            dl, dr, uploaded = staging[i].put(lp, rp, seq)
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(uploaded)
            with span("stream.launch", seq):
                out = part(dl, dr)
            done = torch.cuda.Event()
            done.record(compute)
        else:
            lp, rp = lp.clone(), rp.clone()
            with span("stream.launch", seq):
                out = part(lp, rp)
            done = None
        pending.append((out, done))
    return pending


class StereoStreamProcessor:
    """Double-buffered host->device streaming around the pipeline of
    :func:`make_sharded_pipeline`.

    ``submit`` splits a window over the mesh's ``data`` devices, enqueues
    each share and then waits for the window submitted before it; ``drain``
    waits for and returns the last submitted window (an earlier one, waited
    on by ``submit``, is dropped), as the reference's processor does. On the
    card each data device's frames go through two alternating pinned staging
    buffers, uploaded on its own side copy stream that its compute stream
    (the current stream at ``submit``) waits on, so the next window's upload
    overlaps the current window's kernels; ``drain`` copies each device's
    share straight into the host arrays it returns. On the CPU the window
    is copied and computed in ``submit``. Either way the processor holds its
    own copy of the caller's arrays once ``submit`` returns.
    """

    def __init__(self, mesh: Mesh, maps, Q, matcher: str = "sgbm", params=None, hier_params=None):
        _check_matcher(matcher, params)
        self.mesh = mesh
        self.devices = mesh.axis_devices(DATA_AXIS)
        self.device = self.devices[0]
        self._parts = [_device_part(d, maps, Q, matcher, params, hier_params, False) for d in self.devices]
        self._pending = None  # per data device: ((disparity, points), event or None)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._staging = [_Staging(d) for d in self.devices]

    def submit(self, left, right) -> None:
        """Enqueue a (B, H, W) window, then wait for the previous one."""
        pending = _enqueue(self._parts, self.devices, self._staging if self._cuda else None, left, right)
        prev, self._pending = self._pending, pending
        # Keep at most one window in flight beyond the current one.
        for _, done in prev or ():
            if done is not None:
                done.synchronize()

    def drain(self):
        """Wait for and return the last submitted window's (disparity,
        points) as numpy arrays, or None when nothing is pending."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        outs = []
        for k in (0, 1):
            shards = [out[k] for out, _ in pending]
            b = shards[0].shape[0]
            host = torch.empty((b * len(shards), *shards[0].shape[1:]), dtype=shards[0].dtype)
            for i, (shard, (_, done)) in enumerate(zip(shards, pending)):
                if done is not None:
                    done.synchronize()
                host[i * b:(i + 1) * b].copy_(shard)
            outs.append(host.numpy())
        return tuple(outs)


def _read_back(pending: list, streams: list) -> tuple[list, list]:
    """Start copying a window's per-device outputs (a tensor or a tuple of
    them) into pinned host tensors of the whole window, each device's share
    on its read-back stream once the share is computed; returns the host
    tensors and the copies' events. The device outputs are kept from reuse
    until their copies are done."""
    outs = [out if isinstance(out, tuple) else (out,) for out, _ in pending]
    hosts = []
    for k in range(len(outs[0])):
        shard = outs[0][k]
        hosts.append(torch.empty((shard.shape[0] * len(outs), *shard.shape[1:]), dtype=shard.dtype, pin_memory=True))
    events = []
    for i, ((_, done), stream) in enumerate(zip(pending, streams)):
        stream.wait_event(done)
        with torch.cuda.stream(stream):
            for host, shard in zip(hosts, outs[i]):
                b = shard.shape[0]
                host[i * b:(i + 1) * b].copy_(shard, non_blocking=True)
                shard.record_stream(stream)
            copied = torch.cuda.Event()
            copied.record(stream)
        events.append(copied)
    return hosts, events


def stream_video_pair(
    left_path,
    right_path,
    mesh: Mesh,
    maps,
    Q,
    matcher: str = "sgbm_hier",
    params=None,
    hier_params=None,
    window: int = 8,
    left_start: int = 0,
    right_start: int = 0,
    max_frames: int | None = None,
    depth: int = 3,
    stats_only: bool = False,
):
    """Decode -> disparity -> 3D streaming over a synchronized video pair.

    Three overlapped stages replace the reference's serial per-frame loop
    (3dpose.py:358, ball_drop.py:380):

      1. host decode + native RGB->gray pack (``io.loader.StereoPairLoader``:
         a decode thread a video and the C++ frame ring),
      2. the upload of the next window through pinned staging on a copy
         stream while
      3. the mesh's devices run the current window's remap -> matcher -> Q
         (:func:`make_sharded_pipeline`'s parts), its results copied back
         into pinned host memory on a side stream.

    Each step is a span (``utils.profiling.span``, recorded only inside a
    ``recording()``) carrying its window's seq: ``stream.open`` (the call's
    set-up, to the loader's first window), ``staging.put``,
    ``stream.launch``, ``stream.readback``, ``stream.card_wait`` (the host
    waiting for a window's read-back) and ``stream.close``; the loader's
    ``loader.get``, ``loader.read`` and ``loader.put`` (``io.loader``).

    Yields ``(seq, disparity (T, H, W), points3d (T, H, W, 3), n_valid)``
    per window as numpy arrays, in stream order; the final window is padded
    to the window size by repeating its last frame, ``n_valid`` marking the
    real frames. ``window`` must match the matcher's pack size for
    ``sgbm_hier`` (8 for HIER_FAST) and divide by the mesh's ``data`` axis.
    At most one window is in flight beyond the one being returned, and the
    host waits on the card only for a window's read-back. With
    ``stats_only`` the tuple becomes ``(seq, stats (T, 2), None, n_valid)``:
    two floats a frame cross the bus (``_frame_stats``). A decode error is
    raised here, on the consumer side; the loader is closed when the
    generator ends or is closed.
    """
    opened = span("stream.open")
    opened.__enter__()  # ends at the loader's first window, or with the call
    _check_matcher(matcher, params)
    devices = mesh.axis_devices(DATA_AXIS)
    parts = [_device_part(d, maps, Q, matcher, params, hier_params, stats_only) for d in devices]
    cuda = devices[0].type == "cuda"
    staging = [_Staging(d) for d in devices] if cuda else None
    readback = [torch.cuda.Stream(d) for d in devices] if cuda else None
    loader = StereoPairLoader(left_path, right_path, window, left_start=left_start, right_start=right_start,
                              max_frames=max_frames, depth=depth)

    def dispatch(seq, wl, wr):
        pending = _enqueue(parts, devices, staging, wl, wr, seq)
        if cuda:
            with span("stream.readback", seq):
                return _read_back(pending, readback)
        out = concat_on([out for out, _ in pending], devices[0])
        return list(out) if isinstance(out, tuple) else [out], []

    def emit(item):
        seq, n_valid, (hosts, events) = item
        with span("stream.card_wait", seq):
            for e in events:
                e.synchronize()
        out = [h.numpy() for h in hosts]
        return (seq, out[0], None, n_valid) if stats_only else (seq, out[0], out[1], n_valid)

    inflight: collections.deque = collections.deque()
    try:
        for seq, wl, wr, n_valid in loader:
            if opened is not None:
                opened.__exit__(None, None, None)
                opened = None
            # The card starts on this window while the loader's threads
            # decode the next one; then the previous window is returned.
            inflight.append((seq, n_valid, dispatch(seq, wl, wr)))
            if len(inflight) > 1:
                yield emit(inflight.popleft())
        while inflight:
            yield emit(inflight.popleft())
    finally:
        if opened is not None:
            opened.__exit__(None, None, None)
        with span("stream.close"):
            loader.close()
