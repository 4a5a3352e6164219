"""The (data, space) device mesh and its shardings.

Port of ``stereo_vision_tpu/parallel/mesh.py``: a grid of devices named by
two axes, streams and frames on ``data``, image rows (and the wide feature
dimensions of the detectors) on ``space``. Here the mesh is a plain object
holding a numpy grid of ``torch.device``, driven by one host thread, as the
JAX package drives its mesh from one program: there is no process group.
A device may be named more than once, so a mesh of logical shards of one
card (or of the CPU, :func:`host_cpu_mesh`) runs every band boundary and
every exchange that distinct cards would.

A :class:`NamedSharding` names, for each dimension of a tensor, the mesh
axis (or axes) it is split over (:class:`PartitionSpec`), as JAX's does;
:func:`device_put` splits a host array or tensor into per-device shards by
it and returns a :class:`ShardedTensor` (a plain tensor on a 1x1 mesh).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from stereo_vision_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"


class Mesh:
    """An (n_data, n_space) grid of devices with its axis names, as JAX's
    ``Mesh``: ``devices`` is the numpy grid, ``shape`` the size of each axis
    by name, ``size`` the number of devices."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The mesh's first device, where gathered results land."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at position 0 of the other axes."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out


def create_mesh(n_data: int | None = None, n_space: int = 1, devices: list | None = None) -> Mesh:
    """Build a (data, space) mesh over ``devices`` (default: every CUDA card;
    raises when there is none). A device named more than once gives a mesh
    of logical shards of it.

    Args:
      n_data: devices along the data axis (default: all // n_space).
      n_space: devices along the space axis.
    """
    if devices is None:
        resolve_device(None)  # raises when there is no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    # A bare "cuda" is the current card: name it, so that a tensor's device
    # compares equal to its mesh position's.
    devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in devs]
    if n_data is None:
        n_data = len(devs) // n_space
    need = n_data * n_space
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_space} needs {need} devices, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(n_data, n_space), (DATA_AXIS, SPACE_AXIS))


def host_cpu_mesh(n_devices: int, n_space: int = 1) -> Mesh:
    """An (n_devices // n_space, n_space) mesh of logical CPU devices: the
    counterpart of the JAX package's virtual host devices, and the caller's
    explicit request for the CPU."""
    return create_mesh(n_devices // n_space, n_space, devices=["cpu"] * n_devices)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there already; a copy
    between cards does not wait for the host."""
    return t.to(device, non_blocking=t.device.type == "cuda" and torch.device(device).type == "cuda")


def concat_on(outs: list, device: torch.device):
    """Per-device outputs (tensors, or tuples, lists or dicts of them)
    concatenated along their first dimension on ``device``."""
    o = outs[0]
    if isinstance(o, torch.Tensor):
        return torch.cat([to_device(t, device) for t in outs])
    if isinstance(o, (tuple, list)):
        return type(o)(concat_on(list(parts), device) for parts in zip(*outs))
    if isinstance(o, dict):
        return {k: concat_on([t[k] for t in outs], device) for k in o}
    return o


def on_device(device: torch.device):
    """A context that makes ``device`` current for the kernels' launches (a
    CUDA device), or does nothing (the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class PartitionSpec(tuple):
    """For each dimension of a tensor, the mesh axis it is split over: a
    name, a tuple of names (split over their product, the first major) or
    None (not split); dimensions past the spec's length are not split."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A tensor's layout on a mesh: ``spec`` names the mesh axes each
    dimension is split over; the tensor is replicated over the others."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        for part in self.spec:
            for axis in _axes(part):
                if axis not in mesh.axis_names:
                    raise ValueError(f"unknown mesh axis {axis!r} in {self.spec}")

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) + (None,) * (len(self.spec) - len(other.spec))
                == tuple(self.spec) + (None,) * (len(other.spec) - len(self.spec)))

    def devices_indices_map(self, shape) -> dict[tuple[int, ...], tuple[slice, ...]]:
        """For each mesh position, the slices of a ``shape`` tensor its device
        holds: JAX's ``NamedSharding.devices_indices_map`` keyed by position
        (a device may sit at several). Raises ValueError where a split
        dimension does not divide evenly."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than the shape {shape}")
        sizes = self.mesh.shape
        out = {}
        for pos in np.ndindex(*self.mesh.devices.shape):
            at = dict(zip(self.mesh.axis_names, pos))
            index = []
            for dim, n in enumerate(shape):
                axes = _axes(self.spec[dim]) if dim < len(self.spec) else ()
                if not axes:
                    index.append(slice(None))
                    continue
                parts, k = 1, 0
                for axis in axes:
                    parts, k = parts * sizes[axis], k * sizes[axis] + at[axis]
                if n % parts:
                    raise ValueError(f"dimension {dim} of {shape} is split {parts} ways over {axes}: "
                                     f"it must be divisible by {parts}")
                step = n // parts
                index.append(slice(k * step, (k + 1) * step))
            out[pos] = tuple(index)
        return out


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Split the leading (batch / stream) dimension over ``data``."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_rows_sharding(mesh: Mesh) -> NamedSharding:
    """Split (B, H, W) frames: batch over ``data``, rows over ``space``."""
    return NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """A whole copy on every device."""
    return NamedSharding(mesh, P())


class ShardedTensor:
    """A tensor split over a mesh by ``sharding``: ``shards[pos]`` is the
    piece at mesh position ``pos`` (the slices ``sharding`` gives it), on
    that position's device. Positions that hold the same piece on the same
    device share one tensor."""

    def __init__(self, shards: dict[tuple[int, ...], torch.Tensor], sharding: NamedSharding, shape):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = next(iter(shards.values())).dtype

    def __repr__(self) -> str:
        return f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, sharding={self.sharding})"

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first device)."""
        device = self.sharding.mesh.first if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        with torch.no_grad():
            for pos, index in self.sharding.devices_indices_map(self.shape).items():
                key = tuple((s.start, s.stop) for s in index)
                if key not in done:
                    done.add(key)
                    out[index] = to_device(self.shards[pos], device)
        return out

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def device_put(x, sharding: NamedSharding):
    """Split a host array, a tensor or a :class:`ShardedTensor` into the
    shards of ``sharding``, each moved to its device. Returns a
    :class:`ShardedTensor`, or on a 1x1 mesh a plain tensor on its device.
    A ShardedTensor already laid out so is returned as it is."""
    mesh = sharding.mesh
    if isinstance(x, ShardedTensor):
        if x.sharding == sharding:
            return x
        x = x.gather()
    x = torch.as_tensor(x)
    index_map = sharding.devices_indices_map(x.shape)  # checks the split first
    if mesh.size == 1:
        return x.to(mesh.first)
    shards, placed = {}, {}
    for pos, index in index_map.items():
        dev = mesh.devices[pos]
        key = (str(dev), tuple((s.start, s.stop) for s in index))
        if key not in placed:
            placed[key] = x[index].to(dev, copy=True)
        shards[pos] = placed[key]
    return ShardedTensor(shards, sharding, x.shape)


def split_along(x, mesh: Mesh, axis: str, dim: int = 0) -> list[torch.Tensor]:
    """``x`` in equal pieces along ``dim``, piece k on the k-th device of
    ``axis`` (:meth:`Mesh.axis_devices`). A host array or tensor is sliced
    and moved (no copy for a piece already on its device); a ShardedTensor
    split so gives its own shards, any other is gathered first. Raises
    ValueError where ``dim`` does not divide into the axis's devices."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    k = mesh.axis_names.index(axis)
    if isinstance(x, ShardedTensor):
        spec = PartitionSpec(*([None] * dim), axis)
        if x.shape[dim] % n == 0 and x.sharding == NamedSharding(mesh, spec):
            positions = [tuple(i if j == k else 0 for j in range(mesh.devices.ndim)) for i in range(n)]
            return [x.shards[p] for p in positions]
        x = x.gather()
    x = torch.as_tensor(x)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} must be divisible by the {n} devices of {axis!r}")
    return [piece.to(d) for piece, d in zip(x.chunk(n, dim) if n > 1 else (x,), devices)]
