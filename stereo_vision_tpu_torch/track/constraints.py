"""Anatomical and velocity constraints over pose sequences.

Port of ``stereo_vision_tpu/track/constraints.py``:

- sequence-level limb averaging with the 10-600 mm plausibility gate;
- the midpoint-preserving limb rescale when |len - ref| / ref exceeds the
  tolerance, the 12 limb pairs in order (later pairs see earlier pairs'
  corrections), frames batched;
- the velocity constraint, which replaces an outlier frame by the midpoint
  of the corrected frame before it and the original frame after it: the
  reference's ``lax.scan`` is a loop over time here, its state on the
  sequence's device;
- the per-frame bone-length constraint, which pins joint1 at
  joint2 + unit * ref_len where the deviation exceeds 20%.

Poses are (T, J, 3) float64 with NaN gaps. The entry points take arrays
or tensors (arrays go to ``device``, None: the CUDA card) and return numpy
arrays and host counts, as the reference's host wrappers do.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.ops.rotation import as_tensor
from stereo_vision_tpu_torch.track.joints import DEFAULT_LIMB_LENGTH_VEC, LIMB_PAIR_INDICES

_PAIRS = tuple((int(a), int(b)) for a, b in LIMB_PAIR_INDICES)


def _finite3(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(-1)


def _average_limb_lengths(seq: torch.Tensor) -> torch.Tensor:
    """(P,) mean limb length over the frames where both joints are finite
    and the length is in (10, 600) mm; NaN where no frame qualifies."""
    idx = torch.as_tensor(LIMB_PAIR_INDICES, dtype=torch.long, device=seq.device)
    a = seq[:, idx[:, 0]]  # (T, P, 3)
    b = seq[:, idx[:, 1]]
    d = torch.linalg.vector_norm(torch.nan_to_num(a - b), dim=-1)
    ok = _finite3(a) & _finite3(b) & (d > 10.0) & (d < 600.0)
    s = torch.where(ok, d, 0.0).sum(0)
    n = ok.sum(0)
    return torch.where(n > 0, s / n.clamp(min=1), torch.nan)


def average_limb_lengths(seq, device=None) -> np.ndarray:
    """(P,) numpy vector aligned to LIMB_PAIRS."""
    return _average_limb_lengths(as_tensor(seq, device, torch.float64)).cpu().numpy()


def _anatomical_constraints(seq: torch.Tensor, ref: torch.Tensor, tolerance: float):
    """Midpoint-preserving limb rescale, frames batched, pairs in order."""
    seq = seq.clone()
    count = torch.zeros((), dtype=torch.int64, device=seq.device)
    for p, (i, j) in enumerate(_PAIRS):
        ref_len = ref[p]
        a = seq[:, i].clone()  # (T, 3)
        b = seq[:, j].clone()
        vec = b - a
        cur = torch.linalg.vector_norm(torch.nan_to_num(vec), dim=-1)  # (T,)
        valid = _finite3(a) & _finite3(b) & torch.isfinite(ref_len) & (cur > 1e-9)
        need = valid & (torch.abs(cur - ref_len) / ref_len.clamp(min=1e-9) > tolerance)
        unit = vec / cur.clamp(min=1e-9)[:, None]
        mid = (a + b) * 0.5
        m = need[:, None]
        seq[:, i] = torch.where(m, mid - unit * (ref_len * 0.5), a)
        seq[:, j] = torch.where(m, mid + unit * (ref_len * 0.5), b)
        count += need.sum()
    return seq, count


def apply_anatomical_constraints_sequence(
    seq,
    reference_lengths=None,
    tolerance: float = 0.05,
    device=None,
) -> tuple[np.ndarray, int]:
    """Limb-length constraints over a (T, J, 3) sequence.

    Args:
      reference_lengths: (P,) lengths aligned to LIMB_PAIRS (NaN = skip
        pair). None measures them from the sequence itself; pairs with no
        valid measurement fall back to the default anthropometry table.

    Returns:
      (constrained sequence, number of corrections).
    """
    seq = as_tensor(seq, device, torch.float64)
    if reference_lengths is None:
        measured = _average_limb_lengths(seq)
        default = torch.as_tensor(DEFAULT_LIMB_LENGTH_VEC, device=seq.device)
        ref = torch.where(torch.isfinite(measured), measured, default)
    else:
        ref = as_tensor(reference_lengths, seq.device, torch.float64)
    out, n = _anatomical_constraints(seq, ref, tolerance)
    return out.cpu().numpy(), int(n)


def _velocity_constraints(seq: torch.Tensor, threshold: float):
    """Midpoint replacement of velocity outliers, frame by frame: frame i's
    correction uses the corrected frame i - 1 and the original frame i + 1."""
    out = seq.clone()
    count = torch.zeros((), dtype=torch.int64, device=seq.device)
    prev = seq[0]
    for t in range(1, seq.shape[0] - 1):
        curr, nxt = seq[t], seq[t + 1]
        v_prev = torch.linalg.vector_norm(torch.nan_to_num(curr - prev), dim=-1)
        v_next = torch.linalg.vector_norm(torch.nan_to_num(nxt - curr), dim=-1)
        valid = _finite3(prev) & _finite3(curr) & _finite3(nxt)
        need = valid & ((v_prev > threshold) | (v_next > threshold))
        prev = torch.where(need[:, None], (prev + nxt) * 0.5, curr)
        out[t] = prev
        count += need.sum()
    return out, count


def apply_velocity_constraints(seq, velocity_threshold: float = 50.0, device=None) -> tuple[np.ndarray, int]:
    """Velocity-outlier midpoint replacement over a (T, J, 3) sequence.

    Returns (constrained sequence, number of corrections); sequences
    shorter than 3 frames pass through.
    """
    seq = as_tensor(seq, device, torch.float64)
    if seq.shape[0] < 3:
        return seq.cpu().numpy(), 0
    out, n = _velocity_constraints(seq, velocity_threshold)
    return out.cpu().numpy(), int(n)


def _bone_length_single(pose: torch.Tensor, ref_pose: torch.Tensor, max_dev: float):
    """Per-frame bone constraint: where the current limb deviates more than
    ``max_dev`` from the previous frame's length, move joint1 to
    joint2 + unit * ref_length (joint2 anchored), the torso diagonals left
    out."""
    pose = pose.to(torch.float64).clone()
    count = torch.zeros((), dtype=torch.int64, device=pose.device)
    for i, j in _PAIRS[:10]:
        ref_len = torch.linalg.vector_norm(torch.nan_to_num(ref_pose[i] - ref_pose[j]))
        cur_vec = pose[i] - pose[j]
        cur_len = torch.linalg.vector_norm(torch.nan_to_num(cur_vec))
        valid = (
            torch.isfinite(pose[i]).all()
            & torch.isfinite(pose[j]).all()
            & torch.isfinite(ref_pose[i]).all()
            & torch.isfinite(ref_pose[j]).all()
            & (cur_len > 1e-9)
            & (ref_len > 1e-9)
        )
        need = valid & (torch.abs(cur_len - ref_len) / ref_len.clamp(min=1e-9) > max_dev)
        unit = cur_vec / cur_len.clamp(min=1e-9)
        pose[i] = torch.where(need, pose[j] + unit * ref_len, pose[i])
        count += need
    return pose, count


def apply_bone_length_constraints(pose, reference_pose, max_deviation: float = 0.2,
                                  device=None) -> tuple[np.ndarray, int]:
    """Per-frame bone-length constraint against the previous frame (+-20%
    by default)."""
    pose = as_tensor(pose, device)
    out, n = _bone_length_single(pose, as_tensor(reference_pose, pose.device), max_deviation)
    return out.cpu().numpy(), int(n)
