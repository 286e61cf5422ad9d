"""Meshes of a fake process group: functions, not module constants (importing
this module starts no process group).

The measurement layer traces a step on DTensors whose local tensors are fake,
so no device is touched and one process stands for every rank.
``init_fake_process_group`` starts a ``fake`` process group of 512 ranks (the
2x16x16 production mesh) once per process; each ``Mesh`` is a name->size map
(``mesh.shape[name]``, ``mesh.size``, what the rules and the floors read)
over a range of those ranks, whose ``device_mesh(device_type)`` is the
``DeviceMesh`` the DTensors live on.
"""
from __future__ import annotations

import dataclasses
import math

FAKE_WORLD = 512


def init_fake_process_group(world: int = FAKE_WORLD) -> None:
    """Start the process's default group as a ``fake`` group of ``world``
    ranks (this process is rank 0).  A second call is a no-op; a default
    group of another kind, or of fewer ranks, raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        pg = dist.group.WORLD
        if dist.get_backend(pg) != "fake" or dist.get_world_size() < world:
            raise RuntimeError(f"the default process group is {dist.get_backend(pg)!r} "
                               f"of {dist.get_world_size()} ranks, not 'fake' of {world}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


@dataclasses.dataclass(eq=False)
class Mesh:
    """Mesh axes (name -> size, in order) over ranks ``first .. first + size``."""
    axis_names: tuple
    sizes: tuple
    first: int = 0
    _meshes: dict = dataclasses.field(default_factory=dict, repr=False)
    _parent: "Mesh | None" = dataclasses.field(default=None, repr=False)
    _splits: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda", dims: tuple | None = None):
        """The ``DeviceMesh`` of these ranks for ``device_type`` tensors, or
        its sub-mesh over mesh dims ``dims`` that holds this process's rank."""
        key = device_type if dims is None else (device_type, tuple(dims))
        dm = self._meshes.get(key)
        if dm is None:
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            from torch.utils._python_dispatch import _disable_current_modes
            if dims is not None:
                whole = self.device_mesh(device_type)
            elif self._parent is None:
                init_fake_process_group()
            else:
                self._parent.device_mesh(device_type)
            with _disable_current_modes():   # a split made while a step is traced
                if dims is not None:
                    dm = whole[tuple(dims)]
                else:
                    ranks = torch.arange(self.first, self.first + self.size).reshape(self.sizes)
                    dm = DeviceMesh(device_type, ranks, mesh_dim_names=self.axis_names)
            self._meshes[key] = dm
        return dm

    def split(self, axis: str, lo: int) -> "Mesh":
        """This mesh over the same ranks in the same order, with ``axis``
        split into ``axis_hi`` x ``axis_lo`` (``lo`` ranks), whose
        ``DeviceMesh`` is this one's ranks reshaped: a shard on ``axis`` is
        the same chunk on the same rank as a shard on both halves."""
        out = self._splits.get((axis, lo))
        if out is None:
            i = self.axis_names.index(axis)
            names = self.axis_names[:i] + (f"{axis}_hi", f"{axis}_lo") + self.axis_names[i + 1:]
            sizes = self.sizes[:i] + (self.sizes[i] // lo, lo) + self.sizes[i + 1:]
            out = make_mesh(sizes, names, self.first)
            out._parent = self
            self._splits[(axis, lo)] = out
        return out


def make_mesh(shape, axes, first: int = 0) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape), first)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh(device: str = "cuda") -> Mesh:
    """The local devices as a 1-D 'data' mesh (the GPUs, or one CPU)."""
    import torch
    n = torch.cuda.device_count() if device == "cuda" else 1
    return make_mesh((max(n, 1),), ("data",))
