"""Model checkpoints without orbax.

Port of ``stereo_vision_tpu/models/checkpoint.py``. The reference writes
its flax variable trees with orbax, which the card's machine does not
have; the port writes a format of its own, a ``torch.save`` of the
model's state dict (:func:`save_variables`, :func:`load_variables`). The
dependency-light npz (:func:`save_numpy_tree`) is the reference's: its keys
are ``jax.tree_util.keystr`` of the flax paths (``['params']['Conv_0']
['kernel']``) and its arrays in flax's layouts, so the two packages' files
compare key for key.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from stereo_vision_tpu_torch.models.convert import reference_arrays


def save_variables(path: str | Path, variables: nn.Module) -> None:
    """Write a model's state dict to ``path``, replacing what is there."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in variables.state_dict().items()}, path)


def load_variables(path: str | Path, like: nn.Module | None = None):
    """Read a file of :func:`save_variables`: into the model ``like`` (in
    place, on its device, names and shapes checked; returned), or, without
    ``like``, as a state dict of CPU tensors. Only tensors are unpickled."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    if like is None:
        return state
    like.load_state_dict(state)
    return like


def save_numpy_tree(path: str | Path, variables: nn.Module) -> None:
    """A model's reference variable tree as an npz of flattened flax paths
    (``jax.tree_util.keystr`` of each), arrays in flax's layouts."""
    np.savez(path, **{"".join(f"[{k!r}]" for k in p): a for p, a in reference_arrays(variables)})
