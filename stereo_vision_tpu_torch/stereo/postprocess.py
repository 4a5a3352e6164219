"""Disparity post-processing: left-right consistency and speckle filtering.

Port of ``stereo_vision_tpu/stereo/postprocess.py``:

- :func:`left_right_check`, cv2 validateDisparity against a precomputed
  right disparity (the LR filter for block matching, which has none of its
  own); plain torch, as in JAX (no Pallas kernel);
- :func:`connected_component_labels`, min-propagation + pointer jumping
  over a fixed number of rounds, as in JAX (the labels of the ball mask's
  largest blob, ``detect.circles.largest_component_mask``);
- :func:`speckle_filter`, exact cv2.filterSpeckles: the same gather-free
  five-phase algorithm, written as shifted elementwise torch ops (the proof
  of exactness is in the JAX docstring). It is the plain form of the CUDA
  kernel's wrapper, :func:`.speckle_cuda.speckle_filter`, which both SGBM
  matchers call: at window S it takes about 5(S-1) rounds of small ops.
"""

from __future__ import annotations

import math

import torch

_OFFS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_OPP = (1, 0, 3, 2)


def left_right_check(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    max_diff: float = 1.0,
    invalid_value: float = -1.0,
    max_disparity: int | None = None,
) -> torch.Tensor:
    """Invalidate left-disparity pixels of (..., H, W) maps that fail LR
    consistency: left pixel x with disparity d matches right pixel
    x - round(d), and needs |disp_right[x - round(d)] - d| <= max_diff and
    d >= 0 (cv2 validateDisparity with a precomputed right disparity).

    ``max_disparity``: an upper bound on round(disp_left); the lookup then
    runs as max_disparity + 1 shifts + selects, as the JAX function does
    (a round(d) above the bound fails). Rounding is half-to-even.
    """
    W = disp_left.shape[-1]
    xr_off = torch.round(disp_left).to(torch.int32)  # right pixel = x - off
    if max_disparity is not None:
        Dm = int(max_disparity)
        oob = torch.full((*disp_right.shape[:-1], Dm), float("inf"), dtype=disp_right.dtype,
                         device=disp_right.device)  # |inf - d| > max_diff: fails like out of range
        d2p = torch.cat([oob, disp_right], dim=-1)
        d2 = torch.full_like(disp_right, float("inf"))
        for dd in range(Dm + 1):
            d2 = torch.where(xr_off == dd, d2p[..., Dm - dd : Dm - dd + W], d2)
        in_range = (xr_off >= 0) & (xr_off <= Dm)
    else:
        xr = torch.arange(W, dtype=torch.int32, device=disp_left.device) - xr_off
        in_range = (xr >= 0) & (xr < W)
        d2 = torch.gather(disp_right, -1, xr.clamp(0, W - 1).to(torch.int64))
    ok = in_range & ((d2 - disp_left).abs() <= max_diff) & (disp_left >= 0)
    return torch.where(ok, disp_left, torch.as_tensor(invalid_value, dtype=disp_left.dtype, device=disp_left.device))


def connected_component_labels(
    same_blob_adjacency: list[torch.Tensor],
    valid: torch.Tensor,
    rounds: int | None = None,
) -> torch.Tensor:
    """4-neighbour component labels by min-propagation + two pointer hops a
    round (Shiloach-Vishkin style).

    Args:
      same_blob_adjacency: 4 boolean (H, W) masks for the neighbours at
        (+y, -y, +x, -x), True where the neighbour is in the same blob.
      valid: (H, W) bool; invalid pixels are singleton components.
      rounds: propagation rounds; default ceil(log2(H*W)) + 2.

    Returns:
      (H, W) int32 labels. The rounds are fixed, not run to convergence: a
      long thin component (a serpentine) can keep several labels, and these
      equal the JAX function's bit for bit; with enough rounds each label is
      the least flat index of its component.
    """
    H, W = valid.shape
    if rounds is None:
        rounds = int(math.ceil(math.log2(max(H * W, 2)))) + 2
    lab = torch.arange(H * W, dtype=torch.int32, device=valid.device).reshape(H, W)
    for _ in range(rounds):
        out = lab
        for i, m in enumerate(same_blob_adjacency):  # neighbours read from the round's start
            out = torch.where(m, torch.minimum(out, _nb(lab, i, H * W)), out)
        flat = out.reshape(-1)
        flat = flat[flat.long()]
        lab = flat[flat.long()].reshape(H, W)
    return lab


def _nb(a: torch.Tensor, i: int, fill) -> torch.Tensor:
    """Value of ``a`` at p + _OFFS[i] over the last two axes (``fill``
    outside the image)."""
    dy, dx = _OFFS[i]
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0), H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0), W + min(-dx, 0))
    out[..., yd, xd] = a[..., ys, xs]
    return out


def speckle_rounds(max_speckle_size: int, max_diameter: int | None = None) -> int:
    """R, the rounds of each phase: S - 1, capped at ``max_diameter``, at least 1."""
    S = int(max_speckle_size)
    return max(S - 1 if max_diameter is None else min(S - 1, int(max_diameter)), 1)


def speckle_filter(
    disp: torch.Tensor,
    max_diff: float = 1.0,
    max_speckle_size: int = 100,
    invalid_value: float = -1.0,
    max_diameter: int | None = None,
) -> torch.Tensor:
    """Remove small disparity blobs from (..., H, W) maps.

    4-connected components of valid pixels (``disp > invalid_value``)
    joined where neighbour disparities differ by <= ``max_diff``;
    components of size <= ``max_speckle_size`` become ``invalid_value``.

    With R = S - 1 (S = max_speckle_size): R rounds of label
    min-propagation recording the arrival round; a BFS parent forest with
    R rounds of child-sum up-sweep and R rounds of down-broadcast of the
    root's count; 2R rounds of taint spreading from differing-label edges
    (non-converged components are large and always kept).

    max_diameter: optional cap on R. Blobs of graph diameter <= R are
    still decided exactly; thinner, longer blobs of size <= S are kept
    where cv2 would remove them. None gives exact cv2 semantics.
    """
    H, W = disp.shape[-2:]
    S = int(max_speckle_size)
    if S <= 0:
        return disp
    R = speckle_rounds(S, max_diameter)
    valid = disp > invalid_value
    masks = [
        valid & _nb(valid, i, False) & ((_nb(disp, i, float("inf")) - disp).abs() <= max_diff)
        for i in range(4)
    ]
    big = H * W
    lab = torch.arange(H * W, dtype=torch.int32, device=disp.device).reshape(H, W).expand(disp.shape).clone()
    A = torch.zeros(disp.shape, dtype=torch.int32, device=disp.device)

    # Phase 1: R rounds of min-propagation, tracking the arrival round A.
    for r in range(1, R + 1):
        new = lab
        for i in range(4):
            new = torch.where(masks[i], torch.minimum(new, _nb(lab, i, big)), new)
        A = torch.where(new < lab, r, A)
        lab = new

    # Phase 2: parent direction (4 = root): the first qualifying neighbour.
    pdir = torch.full(disp.shape, 4, dtype=torch.int32, device=disp.device)
    for i in (3, 2, 1, 0):
        ok = masks[i] & (_nb(lab, i, big) == lab) & (_nb(A, i, big) < A)
        pdir = torch.where(ok, i, pdir)
    child = [_nb(pdir, i, 4) == _OPP[i] for i in range(4)]

    # Phase 3: up-sweep — s[p] = descendants of p within t levels.
    s = torch.ones(disp.shape, dtype=torch.int32, device=disp.device)
    for _ in range(R):
        out = torch.ones_like(s)
        for i in range(4):
            out = out + torch.where(child[i], _nb(s, i, 0), 0)
        s = out

    # Phase 4: down-broadcast the root's exact tree size.
    total = torch.where(pdir == 4, s, 0)
    for _ in range(R):
        out = total
        for i in range(4):
            out = torch.where(pdir == i, _nb(total, i, 0), out)
        total = out

    # Phase 5: taint — seed at differing-label same-blob edges, OR-spread.
    taint = torch.zeros(disp.shape, dtype=torch.bool, device=disp.device)
    for i in range(4):
        taint = taint | (masks[i] & (_nb(lab, i, big) != lab))
    for _ in range(2 * R):
        out = taint
        for i in range(4):
            out = out | (masks[i] & _nb(taint, i, False))
        taint = out

    remove = valid & ~taint & (total <= S)
    return torch.where(remove, torch.as_tensor(invalid_value, dtype=disp.dtype, device=disp.device), disp)
