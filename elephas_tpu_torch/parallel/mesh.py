"""A device mesh — counterpart of ``jax.sharding.Mesh`` for the port.

The reference names its devices by mesh axes and runs its
sequence-parallel attention under ``shard_map`` over one of them. The port
runs that attention single-controller: one process holds every shard,
each on the mesh's device for its position, and the collectives become
copies between those devices (:mod:`elephas_tpu_torch.ops.ring_attention`,
:mod:`elephas_tpu_torch.ops.ulysses`).

A mesh may name one device several times: ``Mesh(["cuda:0"] * 4,
("seq",))`` runs four shards on one card, as the reference's CPU tests run
on virtual devices and :func:`~elephas_tpu_torch.device.force_devices`
places several workers on one card. A copy between two positions on the
same device is no copy.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class Mesh:
    """``devices`` (a sequence, or a nested one / numpy array of one
    dimension an axis) named by ``axis_names``.

    ``shape`` maps each axis name to its size, in axis order, as
    ``jax.sharding.Mesh.shape`` does; ``devices`` is the numpy object array
    of ``torch.device``s; :meth:`axis_devices` lists the devices along one
    axis."""

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.axis_names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(self.axis_names):
            raise ValueError(
                f"a mesh of {arr.ndim} device axes needs as many names, got "
                f"{self.axis_names}"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        flat = [torch.device(d) for d in arr.reshape(-1)]
        for d in flat:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"a mesh holds cuda or cpu devices, not {d}")
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis_name: str) -> list[torch.device]:
        """The devices along ``axis_name``, at index 0 of every other axis:
        the positions a one-axis collective runs over."""
        if axis_name not in self.axis_names:
            raise ValueError(f"axis {axis_name!r} not in the mesh axes {self.axis_names}")
        axis = self.axis_names.index(axis_name)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[axis]):
            index[axis] = i
            out.append(self.devices[tuple(index)])
        return out
