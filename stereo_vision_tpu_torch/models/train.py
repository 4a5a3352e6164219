"""Training utilities for the neural detectors on the (data, space) mesh.

Port of ``stereo_vision_tpu/models/train.py``: a training state, the
placement of a model's tensors on the mesh with each tensor's partition
spec (wide 2-D kernels on ``space``, the rest replicated), one training
step, and a batch put on the mesh. The step is data parallel over the
mesh's ``data`` axis and tensor parallel over ``space`` (the wide kernels'
storage split by output rows); it runs in IEEE float32, its backward pass
included (``layers.fp32_forward``). Given the model itself, each data device
runs the forward pass of its own share on a replica of the model, on a host
thread of its own (the threads take turns), and at every layer that reads
batch statistics (a batch norm in training form) the shares' partial sums
meet across the data devices, so that each share normalises by the whole
batch's statistics, as XLA's all-reduce makes the reference's one global
step do. One host thread builds the step and runs the loss, the backward
pass and the optimizer.

Variables are the reference's two collections as flat state dicts of the
port's names, ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}`` (a model's ``named_parameters()`` and ``named_buffers()``); the
step runs a model on them with ``torch.func.functional_call``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import threading
from typing import Any, Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
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


_REFUSED = ("apply_fn read batch statistics (a batch norm in training form) on {n} data devices, where a plain "
            "callable runs each share alone and would normalise it by the share's statistics: pass the model "
            "itself (an nn.Module) as apply_fn, so that each data device runs a replica of it and the shares' "
            "statistics meet at every batch norm")


class _Meeting:
    """The shares' rendezvous in one step. Their threads take turns, share 0
    first, so that one thread at a time launches work (threads running at
    once hand the interpreter's lock to and fro at every operation): a share
    runs until it meets the others at a layer that reads batch statistics,
    posts its per-channel partial sums (float32 sums of x and of x^2 over
    every dimension but the channels, and the count of values), hands the
    turn to the next share and waits for its own. The last share to post
    forms the whole batch's mean and biased variance on the mesh's first
    device, each share takes them back to its device, all differentiably.
    Each share's last post is None (its forward pass is done), so shares
    that reach different numbers of such layers raise ``ValueError``, not
    wait; a share that fails calls :meth:`abort`, and the others raise
    ``threading.BrokenBarrierError`` where they wait for their turn."""

    def __init__(self, n: int, first: torch.device):
        self.n, self.first = n, first
        self.posts: list = [None] * n
        self.total: tuple[torch.Tensor, torch.Tensor] | None = None
        self.turns = [threading.Semaphore(1 if i == 0 else 0) for i in range(n)]
        self.failed = False

    def wait_turn(self, share: int) -> None:
        self.turns[share].acquire()
        if self.failed:
            raise threading.BrokenBarrierError(f"share {share}: another share failed")

    def hand_on(self, share: int) -> None:
        self.turns[(share + 1) % self.n].release()

    def abort(self) -> None:
        self.failed = True
        for t in self.turns:
            t.release()

    def _reduce(self) -> None:
        done = [p is None for p in self.posts]
        if any(done) and not all(done):
            raise ValueError(f"the shares reached different numbers of batch-statistics layers: shares "
                             f"{[i for i, d in enumerate(done) if d]} finished while the others met another")
        if all(done):
            self.total = None
            return
        widths = {p[0].shape for p in self.posts}
        if len(widths) > 1:
            raise ValueError(f"the shares met at batch statistics of different widths: {sorted(widths)}")
        s1, s2 = (torch.stack([to_device(p[k], self.first) for p in self.posts]).sum(0) for k in (0, 1))
        count = sum(p[2] for p in self.posts)
        mean = s1 / count
        # flax's fast variance: E[x^2] - E[x]^2, clamped at 0 (as layers.batch_statistics).
        self.total = mean, torch.maximum(s2 / count - mean * mean, mean.new_zeros(()))

    def meet(self, share: int, x: torch.Tensor | None):
        """Post share ``share``'s partial sums of ``x`` (None: its forward
        pass is done) in its turn and wait for its next; returns the whole
        batch's (mean, variance) on ``x``'s device."""
        if x is None:
            self.posts[share] = None
        else:
            dims = [d for d in range(x.ndim) if d != 1]
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            self.posts[share] = (xf.sum(dims), (xf * xf).sum(dims), x.numel() // x.shape[1])
        if share == self.n - 1:
            self._reduce()
        self.hand_on(share)
        self.wait_turn(share)
        total = self.total  # no share posts again before this one hands the turn on
        return None if total is None else tuple(to_device(t, x.device) for t in total)


class _StepForward(TorchFunctionMode):
    """A forward pass of the step as the reference's runs it, one a share
    (modes are thread-local). The batch statistics it was given
    (``frozen``) stay as they are: an in-place method called on one of them
    is skipped (a batch norm's running statistics, torch's
    ``num_batches_tracked``). A layer that reads batch statistics,
    :func:`.layers.batch_statistics` or ``F.batch_norm`` in training form
    (torch's ``nn.BatchNorm*d``), takes them from ``meet`` (the whole
    batch's, :meth:`_Meeting.meet`) where it is given; else the former
    runs as it is and the latter without its running statistics, on the
    same batch statistics. With ``refuse`` (a plain callable on several data
    devices) such a layer raises ``ValueError``."""

    def __init__(self, frozen, meet: Callable | None = None, refuse: int = 0):
        super().__init__()
        self.frozen = {id(t) for t in frozen}
        self.meet = meet
        self.refuse = refuse

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is batch_statistics:
            if self.refuse:
                raise ValueError(_REFUSED.format(n=self.refuse))
            if self.meet is not None:
                return self.meet(args[0] if args else kwargs["x"])
        if func is F.batch_norm:
            a = {**dict(zip(("input", "running_mean", "running_var", "weight", "bias", "training", "momentum",
                             "eps"), args)), **kwargs}
            if a.get("training", False):
                if self.refuse:
                    raise ValueError(_REFUSED.format(n=self.refuse))
                if self.meet is None:
                    return func(a["input"], None, None, a.get("weight"), a.get("bias"), True,
                                a.get("momentum", 0.1), a.get("eps", 1e-5))
                x = a["input"]
                shape = (1, -1) + (1,) * (x.ndim - 2)
                mean, var = self.meet(x)
                mul = torch.rsqrt(var + a.get("eps", 1e-5))
                if a.get("weight") is not None:
                    mul = mul * a["weight"]
                y = (x - mean.view(shape)) * mul.view(shape)
                return y if a.get("bias") is None else y + a["bias"].view(shape)
        name = getattr(func, "__name__", "")
        if name.endswith("_") and not name.endswith("__") and args and id(args[0]) in self.frozen:
            return args[0]
        return func(*args, **kwargs)


def _each_share(pool: concurrent.futures.ThreadPoolExecutor, n: int, first: torch.device,
                run: Callable[[int, _Meeting], Any]) -> list:
    """``run(i, meeting)`` for i < n, each on a thread of ``pool`` (n
    workers, kept from step to step: cuDNN keeps its execution plans a
    thread), the threads taking turns between the meetings at the batch
    statistics (:class:`_Meeting`); their results in order. The first error
    of the lowest share that failed is raised here, after every share has
    ended."""
    meeting = _Meeting(n, first)
    errors: list = [None] * n

    def work(i: int):
        try:
            meeting.wait_turn(i)
            out = run(i, meeting)
            meeting.meet(i, None)
            meeting.hand_on(i)
            return out
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller's thread
            errors[i] = e
            meeting.abort()

    outs = [f.result() for f in [pool.submit(work, i) for i in range(n)]]
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed if not isinstance(e, threading.BrokenBarrierError)), failed[0])
    return outs


def make_train_step(
    mesh: Mesh,
    apply_fn: nn.Module | Callable[[dict[str, Any], torch.Tensor], Any],
    loss_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    tx: Callable[[list[torch.Tensor]], torch.optim.Optimizer],
):
    """Build a data- and tensor-parallel training step on the mesh.

    Args:
      apply_fn: the model, an ``nn.Module`` whose state dict's names are
        the variables' (``model(batch_inputs)`` -> outputs; a model that
        needs other arguments is wrapped in a module that passes them), or
        a plain callable (variables, batch_inputs) -> model outputs, run as
        given.
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
      the forward pass of its share with the parameters copied to it and
      the split ones gathered there, all differentiably, under its own
      current device. Given a module, each data device runs its own
      replica (``step.replicas``, one a data device in the order of
      :meth:`.mesh.Mesh.axis_devices`: deep copies moved there, made here,
      in the training mode the module has now) with
      ``torch.func.functional_call`` on the variables, on a thread of its
      own (n threads kept by the step; they take turns, one launching at a
      time: the devices still run at once); at every layer that reads
      batch statistics (``layers.BatchNorm``, through
      :func:`.layers.batch_statistics`, or ``F.batch_norm`` in training
      form) the shares' partial sums meet on the mesh's first device and
      each share normalises by the whole batch's statistics, as the
      reference's one global step does (flax's fast variance, the layer's
      own epsilon). A share that raises ends the
      step, whose error it then is; shares that reach different numbers of
      such layers raise ``ValueError``. A plain callable runs the shares
      one after another in this thread, and where it reads batch
      statistics on several data devices it raises ``ValueError``. On one
      data device either form runs the plain forward pass. The outputs are
      concatenated on the mesh's first device, so ``loss_fn`` sees the
      whole batch. ``batch_stats``, where there are any, stay as they are
      on any mesh (the reference's step does not update them either). One
      backward pass in this thread and one optimizer step update the
      masters in place; the step returns (the state with the step counted,
      the loss).
    """
    devices = mesh.axis_devices(DATA_AXIS)
    first = mesh.first
    n = len(devices)
    replicas = [copy.deepcopy(apply_fn).to(dev) for dev in devices] if isinstance(apply_fn, nn.Module) else None
    pool = (concurrent.futures.ThreadPoolExecutor(n, thread_name_prefix="train-step share")
            if replicas is not None and n > 1 else None)

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

            def forward(i: int, meeting: _Meeting | None = None):
                dev = devices[i]
                bstats = {k: to_device(b, dev) for k, b in state.batch_stats.items()}
                params = {k: _on(p, dev) for k, p in state.params.items()}
                refuse = n if replicas is None and n > 1 else 0
                meet = None if meeting is None else functools.partial(meeting.meet, i)
                mode = (_StepForward(bstats.values(), meet, refuse) if bstats or meet or refuse
                        else contextlib.nullcontext())
                with on_device(dev), mode:
                    if replicas is None:
                        return apply_fn({"params": params, "batch_stats": bstats}, shares[i])
                    return torch.func.functional_call(replicas[i], {**params, **bstats}, (shares[i],))

            if pool is not None:
                outs = _each_share(pool, n, first, forward)
            else:
                outs = [forward(i) for i in range(n)]
            loss = loss_fn(outs[0] if n == 1 else concat_on(outs, first), targets)
            loss.backward()
        state.opt_state.step()
        return state._replace(step=state.step + 1), loss.detach()

    step.replicas = replicas
    return init_state, step


def put_batch(mesh: Mesh, batch):
    """A host batch (numpy array or tensor) split over ``data``, its leading
    axis divisible by that axis's size: a :class:`.mesh.ShardedTensor` (a
    1x1 mesh: a tensor on its device)."""
    return device_put(batch, batch_sharding(mesh))
