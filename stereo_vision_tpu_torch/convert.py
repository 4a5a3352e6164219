"""Carry state from the JAX package's objects into the port.

The stereo paths have no weights; their state is the matcher parameters
(and the hierarchical configuration), the rectification maps and Q.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device
from stereo_vision_tpu_torch.stereo.bm import StereoBMParams
from stereo_vision_tpu_torch.stereo.hier import HierParams, MidLevel
from stereo_vision_tpu_torch.stereo.sgbm import StereoSGBMParams


def _fields(p) -> dict:
    """The fields of a JAX params NamedTuple (or a dict) without ``backend``
    (the device decides)."""
    d = dict(p._asdict() if hasattr(p, "_asdict") else p)
    d.pop("backend", None)
    return d


def sgbm_params_from_reference(p) -> StereoSGBMParams:
    """A ``StereoSGBMParams`` from anything with ``_asdict()`` (the JAX
    NamedTuple) or from a dict; ``backend`` is dropped."""
    return StereoSGBMParams(**_fields(p))


def bm_params_from_reference(p) -> StereoBMParams:
    """A ``StereoBMParams`` from the JAX NamedTuple or a dict; ``backend`` is dropped."""
    return StereoBMParams(**_fields(p))


def hier_params_from_reference(hp) -> HierParams:
    """A ``HierParams`` from the JAX NamedTuple (or a dict), field by field;
    each entry of ``mid_levels`` becomes a :class:`MidLevel`."""
    d = dict(hp._asdict() if hasattr(hp, "_asdict") else hp)
    d["mid_levels"] = tuple(
        MidLevel(**(lv._asdict() if hasattr(lv, "_asdict") else dict(lv))) for lv in d.get("mid_levels", ())
    )
    return HierParams(**d)


def pipeline_inputs_from_numpy(maps, Q, device=None):
    """(mx1, my1, mx2, my2) maps and Q as float32 tensors on ``device``
    (None = the CUDA card)."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    return tuple(as_t(m) for m in maps), as_t(Q)
