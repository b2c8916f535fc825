"""Device meshes (port of nodey_tpu.parallel.mesh).

A ``Mesh`` is a grid of torch devices with named axes. One process drives
every device of it (as JAX's ``shard_map`` does): a sharded program is a
loop over the mesh's shards, and a device may appear more than once. A
mesh of ``[cuda:0] * 8`` is a virtual mesh of eight shards on one card,
the counterpart of the JAX package's forced host devices on the CPU.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nodey_tpu_torch.core.errors import ProcessorRuntimeError


class Mesh:
    """Devices laid out on named axes (``devices`` is an object array of
    ``torch.device`` of the axes' sizes)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{list(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str, **at: int) -> List[torch.device]:
        """The devices along ``axis`` in axis order, every other axis fixed
        at the index ``at`` gives it (0 where not given)."""
        index = tuple(slice(None) if name == axis else at.get(name, 0)
                      for name in self.axis_names)
        return list(self.devices[index])

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        out: List[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def _device(d) -> torch.device:
    """``d`` as a concrete device: "cuda" gains the current index; a CUDA
    device without a card raises (``compiler.resolve_device``)."""
    from nodey_tpu_torch.core.compiler import resolve_device

    return resolve_device(d)


def make_mesh(axes: Dict[str, int],
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from an axis-name -> size mapping.

    ``make_mesh({"dp": 2, "sp": 4})`` lays dp-major over the first 8
    devices. Axis sizes must multiply to <= the devices given; pass -1 for
    one axis to absorb the remainder. ``devices`` defaults to the visible
    CUDA cards (with no card that raises: the mesh never falls back to the
    CPU; pass CPU devices to get one) and may repeat a device: ``["cuda:0"]
    * 8`` is a virtual mesh of eight shards on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ProcessorRuntimeError(
                "No CUDA device available",
                "A mesh takes the visible CUDA cards unless it is given its "
                "devices, and none is visible; pass devices (e.g. "
                "['cpu'] * 8) to build a mesh on the CPU.",
                "make_mesh",
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    names = list(axes)
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {total} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), axis_names=names)
