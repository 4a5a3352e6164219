"""The (data, space) device mesh.

Port of ``stereo_vision_tpu/parallel/mesh.py``'s ``DATA_AXIS``,
``SPACE_AXIS`` and ``create_mesh``: a grid of devices named by two axes,
streams and frames on ``data``, image rows on ``space``. Here it is a plain
object holding a numpy grid of ``torch.device``; the pipelines in
:mod:`.streaming` and the training step of ``models.train`` run on a 1x1
mesh (:func:`single_device`). Several cards (a process group, the
row-band SGM) are not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

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


def create_mesh(n_data: int | None = None, n_space: int = 1, devices: list | None = None) -> Mesh:
    """Build a (data, space) mesh over ``devices`` (default: every CUDA card;
    raises when there is none).

    Args:
      n_data: devices along the data axis (default: all // n_space).
      n_space: devices along the space axis.
    """
    if devices is None:
        resolve_device(None)  # raises when there is no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if n_data is None:
        n_data = len(devs) // n_space
    need = n_data * n_space
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_space} needs {need} devices, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return Mesh(arr.reshape(n_data, n_space), (DATA_AXIS, SPACE_AXIS))


def single_device(mesh: Mesh, what: str) -> torch.device:
    """The one device of a 1x1 mesh; a larger mesh raises
    NotImplementedError (``what`` names the refused work)."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: {what} is not ported yet (ROADMAP A.8)"
        )
    return resolve_device(mesh.devices.flat[0])
