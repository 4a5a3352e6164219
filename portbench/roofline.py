"""The least time the card could take for a kernel call: bytes over HBM bandwidth or operations over peak.

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``OPS_PER_S``, ``bound_ms``, ``_nbytes`` and
``_ops`` at commit 32282d13a4194c9fbd48da53129198c48182e76c. Peaks: NVIDIA's H100 SXM data sheet at
700 W: 3.35 TB/s of HBM, and 32-bit integer operations counted at the 67 T/s non-tensor float32 rate (the
data sheet gives no int32 rate; int32 issues at most that fast, so the bound stays a bound). Bytes are
every input and output tensor once.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(e) for e in x)
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    return 0


def ops(name: str, args, kwargs, elems: int) -> int:
    """32-bit operations of one kernel call (``elems``: its first output's elements): BM ~8 per (valid
    pixel, disparity), the fused R->L scan + WTA ~21 per (pixel, disparity), banded cost ~20 + 4 bs per
    lane, exact cost ~20 + 2 (bs - 1) per (pixel, disparity), a scan step ~10 per lane and carry (two
    directions; three carries each with diagonals), WTA ~10 per lane, LR ~20 per pixel, the pyramid one add
    per input pixel, speckle ~30 per pixel."""
    if name == "banded_cost":
        return elems * (20 + 4 * kwargs["block_size"])
    if name == "cost":
        return elems * (20 + 2 * (kwargs["block_size"] - 1))
    if name == "vertical":
        return (6 if args[3] else 2) * elems * 10
    if name == "banded_vertical":
        return (6 if kwargs.get("with_diagonals") else 2) * elems * 10
    if name == "speckle_filter":
        return elems * 30
    if name in ("banded_wta", "banded_wta_fused", "wta4"):
        return args[0][0].numel() * 10
    if name == "downsample_pyramid":
        return 2 * args[0].numel()
    if name == "horizontal_rl_wta":
        return args[0].numel() * 21
    if name == "bm_disparity":
        return elems * kwargs["ndisp"] * 8
    return elems * (20 if name in ("lr_fail_packed", "lr_fail") else 10)


def flat(x) -> tuple:
    """The tensors of x (a tensor, or tuples and lists of them), in order."""
    if isinstance(x, torch.Tensor):
        return (x,)
    if isinstance(x, (list, tuple)):
        return tuple(t for e in x for t in flat(e))
    return ()


def call_bound(name: str, args, kwargs, out) -> tuple[float, float]:
    """(bytes, operations) of one recorded wrapper call."""
    outs = flat(out)
    return nbytes(args) + nbytes(kwargs) + nbytes(outs), ops(name, args, kwargs, outs[0].numel() if outs else 0)
