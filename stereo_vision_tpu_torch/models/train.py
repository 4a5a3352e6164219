"""Training utilities for the neural detectors on the (data, space) mesh.

Port of ``stereo_vision_tpu/models/train.py``: a training state, the
placement of a model's tensors on the mesh with each tensor's partition
spec (wide 2-D kernels on ``space``, the rest replicated), one training
step, and a batch put on the mesh. The step is data parallel over the
mesh's ``data`` axis and tensor parallel over ``space`` (the wide kernels'
storage split by output rows), driven by one host thread; it runs in IEEE
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
from stereo_vision_tpu_torch.parallel.mesh import (DATA_AXIS, SPACE_AXIS, Mesh, NamedSharding, PartitionSpec,
                                                   ShardedTensor, batch_sharding, concat_on, device_put, on_device,
                                                   split_along, to_device)


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor | ShardedTensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    step: torch.Tensor


def _spec(t: torch.Tensor, n_space: int, tp_min_features: int) -> tuple:
    # A 2-D tensor is a Linear weight, (out, in): flax's kernel is its
    # transpose, so flax's last dimension is torch's first.
    if t.ndim == 2 and t.shape[0] >= tp_min_features and t.shape[0] % n_space == 0:
        return (None, SPACE_AXIS)
    return ()


def _copy(v: torch.Tensor, device: torch.device) -> torch.Tensor:
    return v.detach().to(device, copy=True).requires_grad_(v.requires_grad)


def shard_variables(mesh: Mesh, variables: Mapping[str, torch.Tensor], tp_min_features: int = 128):
    """Place a state dict on the mesh: the 2-D kernels whose output width
    (flax's last dimension) is at least ``tp_min_features`` and divides by
    the ``space`` axis take the spec ``(None, "space")`` (tensor
    parallelism), everything else ``()`` (replicated). Returns (placed
    copies, leaving ``variables`` as they are, with their ``requires_grad``;
    the spec of each name).

    A ``(None, "space")`` tensor's storage is split by output rows over the
    ``space`` devices of the mesh's first data row (a
    :class:`.mesh.ShardedTensor`, each shard a leaf); with one ``space``
    device it stays whole. The rest live on the mesh's first device: the
    training step copies them to each data device."""
    n_space = mesh.shape[SPACE_AXIS]
    specs = {k: _spec(v, n_space, tp_min_features) for k, v in variables.items()}
    if n_space > 1:
        rows = NamedSharding(Mesh(mesh.devices[:1], mesh.axis_names), PartitionSpec(SPACE_AXIS))
    placed = {}
    for k, v in variables.items():
        if specs[k] and n_space > 1:
            placed[k] = device_put(v.detach(), rows)
            for shard in placed[k].shards.values():
                shard.requires_grad_(v.requires_grad)
        else:
            placed[k] = _copy(v, mesh.first)
    return placed, specs


def _leaves(params: Mapping[str, torch.Tensor | ShardedTensor]) -> list[torch.Tensor]:
    """The tensors an optimizer updates: each whole tensor, each shard."""
    out = []
    for v in params.values():
        out += list(v.shards.values()) if isinstance(v, ShardedTensor) else [v]
    return out


def _on(p: torch.Tensor | ShardedTensor, device: torch.device) -> torch.Tensor:
    """A parameter whole on ``device``, differentiably: a split one gathered
    by its output rows, a whole one copied (itself where it lies there)."""
    if isinstance(p, ShardedTensor):
        return torch.cat([to_device(p.shards[pos], device) for pos in sorted(p.shards)])
    return to_device(p, device)


def make_train_step(
    mesh: Mesh,
    apply_fn: Callable[[dict[str, Any], torch.Tensor], Any],
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    tx: Callable[[list[torch.Tensor]], torch.optim.Optimizer],
):
    """Build a data- and tensor-parallel training step on the mesh.

    Args:
      apply_fn: (variables, batch_inputs) -> model outputs, run as given.
      loss_fn: (outputs, batch_targets) -> scalar loss.
      tx: a factory that takes the list of parameter tensors and returns a
        ``torch.optim.Optimizer`` over them (e.g. ``lambda p:
        torch.optim.Adam(p, 1e-3)``).

    Returns:
      (init_state, step): ``init_state(variables)`` places copies of the
      variables on the mesh (:func:`shard_variables`; ``batch_stats`` whole
      on the first device) and wraps them with a fresh optimizer over the
      master tensors (each shard of a split one) and a step count of 0.
      ``step(state, inputs, targets)`` splits the inputs over ``data``
      (host arrays, tensors, or :func:`put_batch`'s); each data device runs
      ``apply_fn`` on its share with the parameters copied to it and the
      split ones gathered there, all differentiably, under its own current
      device. The outputs are concatenated on the mesh's first device, so
      ``loss_fn`` sees the whole batch, as the reference's global step does
      (a layer that reads batch statistics sees its device's share). One
      backward pass and one optimizer step update the masters in place; the
      step returns (the state with the step counted, the loss). The step does
      not update ``batch_stats``, as the reference's does not.
    """
    devices = mesh.axis_devices(DATA_AXIS)
    first = mesh.first

    def init_state(variables: Mapping[str, Mapping[str, torch.Tensor]]) -> TrainState:
        params, _ = shard_variables(mesh, variables["params"])
        bstats = {k: _copy(v, first) for k, v in variables.get("batch_stats", {}).items()}
        return TrainState(params, bstats, tx(_leaves(params)), torch.zeros((), dtype=torch.int32, device=first))

    def step(state: TrainState, inputs, targets):
        shares = split_along(inputs, mesh, DATA_AXIS)
        targets = targets.gather(first) if isinstance(targets, ShardedTensor) else torch.as_tensor(targets,
                                                                                                  device=first)
        state.opt_state.zero_grad(set_to_none=True)
        with fp32_forward():
            outs = []
            for dev, x in zip(devices, shares):
                with on_device(dev):
                    variables = {"params": {k: _on(p, dev) for k, p in state.params.items()},
                                 "batch_stats": {k: to_device(b, dev) for k, b in state.batch_stats.items()}}
                    outs.append(apply_fn(variables, x))
            loss = loss_fn(outs[0] if len(outs) == 1 else concat_on(outs, first), targets)
            loss.backward()
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss.detach()

    return init_state, step


def put_batch(mesh: Mesh, batch):
    """A host batch (numpy array or tensor) split over ``data``, its leading
    axis divisible by that axis's size: a :class:`.mesh.ShardedTensor` (a
    1x1 mesh: a tensor on its device)."""
    return device_put(batch, batch_sharding(mesh))
