"""SGM over row bands of the mesh: the frame-pipelined aggregation and the
whole SGBM.

Port of ``stereo_vision_tpu/parallel/sgm_sharded.py``. The rows of each
frame are split into one band per device on the ``space`` axis, and the
vertical and diagonal scans run as a pipeline of devices:

- the three downward directions sweep the bands in device order 0 -> S-1,
  the three upward ones S-1 -> 0; the horizontal pair stays within a band;
- the carry between bands is the SGM state of each direction at the
  band's last row, ((Lv, mv), (Ld, md), (Lu, mu)), moved one device over;
  the head of each sweep starts from zeros, SGM's border (L = 0, min = 0);
- at tick t band s runs the downward set of frame t - s and the upward set
  of frame t - (S-1-s), so F frames finish in F + S - 1 ticks.

One host thread drives the pipeline, as the JAX package's single program
does: each band's work is dispatched under its device (``on_device``) on
that device's current stream, and a carry crosses with a non-blocking
copy, which PyTorch orders after the sending stream's work and before the
receiving stream's by events. Ticks whose frame is out of range are
skipped (the reference computes them and throws them away); the result is
the same.

The band scan with an injected carry is plain torch on the CPU and on the
card alike (the reference's is a ``lax.scan``, not a Pallas kernel). On the
card the band-local horizontals run :func:`.sgm_cuda.horizontal` (the port
of ``_horizontal_kernel``, in its int32 form), and :func:`stereo_sgbm_sharded`'s
band-local finish :func:`.sgm_cuda.wta_stats` and :func:`.lr_cuda.lr_fail`
and its whole-frame speckle :func:`.speckle_cuda.speckle_filter`; on the
CPU each of them runs its plain form. Results are bit-exact against the
one-device aggregation and ``stereo_sgbm``.
"""

from __future__ import annotations

import torch

from stereo_vision_tpu_torch.parallel.mesh import SPACE_AXIS, Mesh, on_device, split_along, to_device
from stereo_vision_tpu_torch.stereo import lr_cuda, sgm_cuda
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams, compute_pixel_cost, subpixel_disp16
from stereo_vision_tpu_torch.stereo.sgm_cuda import _sgm_update, _shift_cols
from stereo_vision_tpu_torch.stereo.speckle_cuda import speckle_filter


def _zero_carry(N: int, W: int, D: int, device: torch.device):
    z = (torch.zeros((N, W, D), dtype=torch.int32, device=device),
         torch.zeros((N, W, 1), dtype=torch.int32, device=device))
    return (z, z, z)


def _band_scan(C: torch.Tensor, carry, P1: int, P2: int, with_diag: bool):
    """Scan (N, Hb, W, D) int32 bands downward from the injected carries.

    carry: ((Lv, mv), (Ld, md), (Lu, mu)), each (N, W, D) and (N, W, 1): the
    vertical and the two diagonal directions' states at the row just above
    the band (the diagonals' column shift happens inside the step, so a
    carry crosses the band boundary untransformed). Returns the band's
    summed direction volume and the carries at its last row."""
    (Lv, mv), (Ld, md), (Lu, mu) = carry
    S = torch.empty_like(C)
    for y in range(C.shape[1]):
        c = C[:, y]
        Lv, mv = _sgm_update(c, Lv, mv, P1, P2)
        if with_diag:
            Ld, md = _sgm_update(c, _shift_cols(Ld, 1), _shift_cols(md, 1), P1, P2)
            Lu, mu = _sgm_update(c, _shift_cols(Lu, -1), _shift_cols(mu, -1), P1, P2)
            S[:, y] = Lv + Ld + Lu
        else:
            S[:, y] = Lv
    return S, ((Lv, mv), (Ld, md), (Lu, mu))


def _take(carry, i: int, device: torch.device):
    """Set ``i`` of a stacked carry, moved to ``device``."""
    return tuple((to_device(L[i:i + 1], device), to_device(m[i:i + 1], device)) for L, m in carry)


def aggregate_bands(bands: list[torch.Tensor], devices: list[torch.device], P1: int, P2: int, num_paths: int,
                    cost_bound: int) -> list[torch.Tensor]:
    """The frame-pipelined aggregation of row bands (the host loop that
    stands for the reference's ``_aggregate_pipelined_local`` on every
    device at once).

    ``bands[s]``: band s of each frame's cost volume, (F, Hb, W, D) int32 on
    ``devices[s]``. Returns each band aggregated over ``num_paths`` in {2,
    3, 4, 8} directions, int32, on its device: concatenated, bit-exact
    against the one-device aggregation. ``cost_bound`` bounds the costs
    (the horizontal kernel's check). ``aggregate_bands.band_ticks`` counts
    the (band, tick) pairs run."""
    S = len(bands)
    F = bands[0].shape[0]
    with_diag = num_paths >= 8
    out = [torch.zeros_like(b) for b in bands]
    dn: list = [None] * S  # the carry entering band s's downward set this tick (None: zeros)
    up: list = [None] * S
    for t in range(F + S - 1):
        dn_next: list = [None] * S
        up_next: list = [None] * S
        for s in range(S):
            sets = [(f, down) for f, down in ((t - s, True), (t - (S - 1 - s), False)) if 0 <= f < F]
            if not sets:
                continue
            dev, band = devices[s], bands[s]
            with on_device(dev):
                _, _, W, D = band.shape
                carries = [(dn if down else up)[s] or _zero_carry(1, W, D, dev) for _, down in sets]
                # Both sets of the tick in one scan: the upward one is the y-flipped band.
                C = torch.stack([band[f] if down else band[f].flip(0) for f, down in sets])
                carry = tuple((torch.cat([c[k][0] for c in carries]), torch.cat([c[k][1] for c in carries]))
                              for k in range(3)) if len(sets) > 1 else carries[0]
                Sset, carry = _band_scan(C, carry, P1, P2, with_diag)
                for i, (f, down) in enumerate(sets):
                    if down:
                        # The horizontals, band-local, fold in on the downward tick
                        # (L->R at num_paths >= 3, R->L at >= 4).
                        out[s][f] += Sset[i]
                        if num_paths >= 3:
                            out[s][f] += sgm_cuda.horizontal(band[f][None], P1, P2, False, cost_bound)[0]
                        if num_paths >= 4:
                            out[s][f] += sgm_cuda.horizontal(band[f][None], P1, P2, True, cost_bound)[0]
                        if s + 1 < S:
                            dn_next[s + 1] = _take(carry, i, devices[s + 1])
                    else:
                        out[s][f] += Sset[i].flip(0)
                        if s > 0:
                            up_next[s - 1] = _take(carry, i, devices[s - 1])
            aggregate_bands.band_ticks += 1
        dn, up = dn_next, up_next
    return out


aggregate_bands.band_ticks = 0


def _check_bands(H: int, mesh: Mesh, axis: str) -> list[torch.device]:
    devices = mesh.axis_devices(axis)
    if H % len(devices):
        raise ValueError(f"H={H} must be divisible by the band count {len(devices)}")
    return devices


def sgm_aggregate_sharded(C, P1: int, P2: int, mesh: Mesh, num_paths: int = 8, axis: str = SPACE_AXIS
                          ) -> torch.Tensor:
    """Aggregate a stream of cost volumes over a pipeline of devices.

    Args:
      C: (F, H, W, D) integer cost volumes (frames F are the pipeline's
        axis), a host array, a tensor or a :class:`.mesh.ShardedTensor`;
        H must divide into ``mesh.shape[axis]`` bands (ValueError).
      mesh: the mesh; the rows go over ``axis`` (its devices at position 0
        of the other axes).

    Returns:
      (F, H, W, D) int32 aggregated volumes on the axis's first device, the
      bands concatenated: bit-exact against the one-device
      ``sgm_cuda._aggregate_8`` (``aggregate_8`` on the card) of each frame.
    """
    if num_paths not in (2, 3, 4, 8):
        raise ValueError(f"num_paths must be 2, 3, 4 or 8, got {num_paths}")
    devices = _check_bands(C.shape[1], mesh, axis)
    bands = [b.to(torch.int32).contiguous() for b in split_along(C, mesh, axis, dim=1)]
    cost_bound = max((int(b.max()) for b in bands if b.numel()), default=0)
    out = aggregate_bands(bands, devices, P1, P2, num_paths, cost_bound)
    return torch.cat([to_device(o, devices[0]) for o in out], dim=1)


def _box_rows_valid(x: torch.Tensor, bs: int) -> torch.Tensor:
    """bs-row box sum, 'valid' over dim 1 of (F, rows, W, D) (the caller
    supplies exactly bs // 2 halo rows on each side)."""
    H = x.shape[1] - (bs - 1)
    y = x[:, 0:H].clone()
    for k in range(1, bs):
        y += x[:, k:k + H]
    return y


def _box_cols_same(x: torch.Tensor, bs: int) -> torch.Tensor:
    """bs-column box sum over dim 2 of (F, rows, W, D), replicate-padded
    (cv2's clamp): the column half of the box filter."""
    r = bs // 2
    W = x.shape[2]
    xp = torch.cat([x[:, :, :1]] * r + [x] + [x[:, :, -1:]] * r, dim=2)
    out = xp[:, :, 0:W].clone()
    for k in range(1, bs):
        out += xp[:, :, k:k + W]
    return out


def stereo_sgbm_sharded(left, right, params: StereoSGBMParams, mesh: Mesh, axis: str = SPACE_AXIS) -> torch.Tensor:
    """The whole SGBM on row bands of the mesh, each stage band by band:

    1. cost: each band takes ``block_size // 2 + 1`` raw rows from each
       neighbour (the box's reach and the Sobel's); at the image's true
       borders its own edge row is replicated instead (cv2's rule for the
       raw image's Sobel), and the pixel-cost rows past the border are then
       replaced by the edge row's (cv2's box filter replicates pixel-cost
       rows: the two rules differ on purpose); then the box sums;
    2. the pipelined aggregation (:func:`aggregate_bands`);
    3. WTA, uniqueness, subpixel and the LR check, band-local;
    4. speckle: components span bands, so the bands are gathered on the
       axis's first device and filtered once.

    Args:
      left, right: (F, H, W) rectified 8-bit frame stacks (host arrays,
        tensors or :class:`.mesh.ShardedTensor`); H must divide by the
        axis's size (ValueError), each band must hold ``block_size // 2 +
        1`` rows.
      params: the SGBM parameters; ``min_disparity`` must be 0 (ValueError),
        as the reference asserts.

    Returns:
      (F, H, W) float32 disparities on the axis's first device, invalid -1:
      bit-exact against ``stereo_sgbm`` of each frame.
    """
    if params.min_disparity != 0:
        raise ValueError("the sharded SGBM assumes min_disparity == 0")
    F, H, W = left.shape
    devices = _check_bands(H, mesh, axis)
    S = len(devices)
    Hb = H // S
    ndisp, bs = params.num_disparities, params.block_size
    minX1 = ndisp
    r = bs // 2
    halo = r + 1  # the box's reach + the Sobel's one row
    if Hb < halo:
        raise ValueError(f"each of the {S} bands of {Hb} rows needs at least block_size // 2 + 1 = {halo}")
    lb, rb = split_along(left, mesh, axis, dim=1), split_along(right, mesh, axis, dim=1)

    def with_halo(x, s):
        above = to_device(x[s - 1][:, -halo:], devices[s]) if s > 0 else x[s][:, :1].expand(F, halo, W)
        below = to_device(x[s + 1][:, :halo], devices[s]) if s < S - 1 else x[s][:, -1:].expand(F, halo, W)
        return torch.cat([above, x[s], below], dim=1)

    costs = []
    for s, dev in enumerate(devices):
        with on_device(dev):
            # Rows 1 .. Hb + 2r of the extended band have their Sobel context.
            pix = compute_pixel_cost(with_halo(lb, s), with_halo(rb, s), params)[:, 1:Hb + 2 * r + 1]
            if s == 0:
                pix[:, :r] = pix[:, r:r + 1]
            if s == S - 1:
                pix[:, Hb + r:] = pix[:, Hb + r - 1:Hb + r]
            costs.append(_box_cols_same(_box_rows_valid(pix, bs), bs)[:, :, minX1:].to(torch.int32).contiguous())
    agg = aggregate_bands(costs, devices, params.P1, params.P2, params.num_paths, params.cost_bound)
    del costs

    bands = []
    for S_f, dev in zip(agg, devices):
        with on_device(dev):
            minS, best, sm, s0, sp, valid = sgm_cuda.wta_stats(S_f, params.uniqueness_ratio)
            disp = subpixel_disp16(best, sm, s0, sp, ndisp).to(torch.float32) / 16.0
            if params.disp12_max_diff >= 0:
                valid = valid & ~lr_cuda.lr_fail(minS, best, disp, W=W, min_x=minX1, ndisp=ndisp, mindisp=0,
                                                 max_diff=params.disp12_max_diff)
            full = torch.full((F, Hb, W), -1.0, dtype=torch.float32, device=dev)
            full[..., minX1:] = torch.where(valid, disp, -1.0)
            bands.append(full)
    del agg
    first = devices[0]
    out = torch.cat([to_device(b, first) for b in bands], dim=1)
    if params.speckle_window_size > 0:
        with on_device(first):
            out = speckle_filter(out, max_diff=float(params.speckle_range),
                                 max_speckle_size=params.speckle_window_size, invalid_value=-1.0)
    return out
