"""Training utilities for the neural detectors on the (data, space) mesh.

Port of ``stereo_vision_tpu/models/train.py``: a training state, the
placement of a model's tensors on the mesh with each tensor's partition
spec (wide 2-D kernels on ``space``, the rest replicated), one training
step, and a batch put on the mesh. The step is data parallel over the
mesh's ``data`` axis and tensor parallel over ``space`` (the wide kernels'
storage split by output rows), driven by one host thread; it runs in IEEE
float32, its backward pass included (``layers.fp32_forward``). A forward
pass that reads batch statistics (a batch norm in training form) runs on the
whole batch on the mesh's first device, so that its statistics are the whole
batch's, as in the reference's one global step; such a model's step is not
data parallel.

Variables are the reference's two collections as flat state dicts of the
port's names, ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` (a model's ``named_parameters()`` and ``named_buffers()``). An
``apply_fn`` runs a model on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from stereo_vision_tpu_torch.models.layers import batch_statistics, fp32_forward
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


class BatchStatisticsRead(Exception):
    """A layer read batch statistics in a probing forward pass."""


class _StepForward(TorchFunctionMode):
    """A forward pass of the step as the reference's runs it. The batch
    statistics it was given (``frozen``) stay as they are: an in-place
    method called on one of them is skipped (a batch norm's running
    statistics, torch's ``num_batches_tracked``), and ``F.batch_norm`` in
    training form (torch's ``nn.BatchNorm*d``) runs without its running
    statistics, on the same batch statistics. With ``refuse`` (a probe) a
    layer that reads batch statistics, that form or
    :func:`.layers.batch_statistics`, raises :class:`BatchStatisticsRead`."""

    def __init__(self, frozen, refuse: bool = False):
        super().__init__()
        self.frozen = {id(t) for t in frozen}
        self.refuse = refuse

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is batch_statistics and self.refuse:
            raise BatchStatisticsRead("batch_statistics")
        if func is F.batch_norm:
            a = {**dict(zip(("input", "running_mean", "running_var", "weight", "bias", "training", "momentum",
                             "eps"), args)), **kwargs}
            if a.get("training", False):
                if self.refuse:
                    raise BatchStatisticsRead("batch_norm")
                return func(a["input"], None, None, a.get("weight"), a.get("bias"), True, a.get("momentum", 0.1),
                            a.get("eps", 1e-5))
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.endswith("__") and args and id(args[0]) in self.frozen:
            return args[0]
        return func(*args, **kwargs)


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
      ``loss_fn`` sees the whole batch, as the reference's global step does.
      A layer that reads batch statistics (``layers.BatchNorm`` or torch's
      ``F.batch_norm`` in training form) must see the whole batch's, as in
      the reference's: on several data devices the first share's forward
      pass runs as a probe that stops at such a layer, and once one has
      stopped, every step runs ``apply_fn`` once on the whole batch on the
      mesh's first device (the split parameters gathered there), without a
      probe. ``batch_stats``, where there are any, stay as they are on any
      mesh (the reference's step does not update them either). One backward
      pass and one optimizer step update the masters in place; the step
      returns (the state with the step counted, the loss).
    """
    devices = mesh.axis_devices(DATA_AXIS)
    first = mesh.first
    reads_batch_statistics = False  # set where a probe stopped

    def init_state(variables: Mapping[str, Mapping[str, torch.Tensor]]) -> TrainState:
        params, _ = shard_variables(mesh, variables["params"])
        bstats = {k: _copy(v, first) for k, v in variables.get("batch_stats", {}).items()}
        return TrainState(params, bstats, tx(_leaves(params)), torch.zeros((), dtype=torch.int32, device=first))

    def step(state: TrainState, inputs, targets):
        nonlocal reads_batch_statistics
        shares = split_along(inputs, mesh, DATA_AXIS)
        targets = targets.gather(first) if isinstance(targets, ShardedTensor) else torch.as_tensor(targets,
                                                                                                  device=first)
        state.opt_state.zero_grad(set_to_none=True)
        with fp32_forward():

            def forward(dev: torch.device, x, refuse: bool = False):
                bstats = {k: to_device(b, dev) for k, b in state.batch_stats.items()}
                variables = {"params": {k: _on(p, dev) for k, p in state.params.items()}, "batch_stats": bstats}
                mode = _StepForward(bstats.values(), refuse) if bstats or refuse else contextlib.nullcontext()
                with on_device(dev), mode:
                    return apply_fn(variables, x)

            outs = None
            if len(devices) == 1:
                outs = [forward(first, shares[0])]
            elif not reads_batch_statistics:
                try:
                    outs = [forward(dev, x, refuse=True) for dev, x in zip(devices, shares)]
                except BatchStatisticsRead:
                    reads_batch_statistics = True
            if outs is None:
                outs = [forward(first, torch.cat([to_device(x, first) for x in shares]))]
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
