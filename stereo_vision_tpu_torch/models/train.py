"""Training utilities for the neural detectors on the (data, space) mesh.

Port of ``stereo_vision_tpu/models/train.py``: a training state, the
placement of a model's tensors on the mesh with each tensor's partition
spec (wide 2-D kernels on ``space``, the rest replicated), one training
step, and a batch put on the mesh. The port runs on a 1x1 mesh; a larger
one raises NotImplementedError (ROADMAP A.8). The step runs in IEEE
float32, its backward pass included (``layers.fp32_forward``).

Variables are the reference's two collections as flat state dicts of the
port's names, ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` (a model's ``named_parameters()`` and ``named_buffers()``). An
``apply_fn`` runs a model on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import torch

from stereo_vision_tpu_torch.models.layers import fp32_forward
from stereo_vision_tpu_torch.parallel.mesh import SPACE_AXIS, Mesh, single_device

_WHAT = "training on several devices"


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: torch.Tensor


def _spec(t: torch.Tensor, n_space: int, tp_min_features: int) -> tuple:
    # A 2-D tensor is a Linear weight, (out, in): flax's kernel is its
    # transpose, so flax's last dimension is torch's first.
    if t.ndim == 2 and t.shape[0] >= tp_min_features and t.shape[0] % n_space == 0:
        return (None, SPACE_AXIS)
    return ()


def shard_variables(mesh: Mesh, variables: Mapping[str, torch.Tensor], tp_min_features: int = 128):
    """Place a state dict on the mesh: the 2-D kernels whose output width
    (flax's last dimension) is at least ``tp_min_features`` and divides by
    the ``space`` axis take the spec ``(None, "space")`` (tensor
    parallelism), everything else ``()`` (replicated). Returns (placed
    copies, leaving ``variables`` as they are, with their ``requires_grad``;
    the spec of each name)."""
    dev = single_device(mesh, _WHAT)
    n_space = mesh.shape[SPACE_AXIS]
    specs = {k: _spec(v, n_space, tp_min_features) for k, v in variables.items()}
    placed = {k: v.detach().to(dev, copy=True).requires_grad_(v.requires_grad) for k, v in variables.items()}
    return placed, specs


def make_train_step(
    mesh: Mesh,
    apply_fn: Callable[[dict[str, Any], torch.Tensor], Any],
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    tx: Callable[[list[torch.Tensor]], torch.optim.Optimizer],
):
    """Build a training step on the mesh.

    Args:
      apply_fn: (variables, batch_inputs) -> model outputs, run as given.
      loss_fn: (outputs, batch_targets) -> scalar loss.
      tx: a factory that takes the list of parameter tensors and returns a
        ``torch.optim.Optimizer`` over them (e.g. ``lambda p:
        torch.optim.Adam(p, 1e-3)``).

    Returns:
      (init_state, step): ``init_state(variables)`` places copies of the
      variables on the mesh and wraps them with a fresh optimizer and a step
      count of 0; ``step(state, inputs, targets)`` puts the batch on the
      mesh, runs one update of the parameters in place and returns (the
      state with the step counted, the loss). The step does not update
      ``batch_stats``, as the reference's does not.
    """
    dev = single_device(mesh, _WHAT)

    def init_state(variables: Mapping[str, Mapping[str, torch.Tensor]]) -> TrainState:
        params, _ = shard_variables(mesh, variables["params"])
        bstats, _ = shard_variables(mesh, variables.get("batch_stats", {}))
        return TrainState(params, bstats, tx(list(params.values())), torch.zeros((), dtype=torch.int32, device=dev))

    def step(state: TrainState, inputs, targets):
        inputs, targets = put_batch(mesh, inputs), put_batch(mesh, targets)
        state.opt_state.zero_grad(set_to_none=True)
        with fp32_forward():
            loss = loss_fn(apply_fn({"params": state.params, "batch_stats": state.batch_stats}, inputs), targets)
            loss.backward()
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss.detach()

    return init_state, step


def put_batch(mesh: Mesh, batch) -> torch.Tensor:
    """A host batch (numpy array or tensor) on the mesh, its leading axis on
    ``data`` (a 1x1 mesh: on its device)."""
    dev = single_device(mesh, _WHAT)
    return torch.as_tensor(batch, device=dev)
