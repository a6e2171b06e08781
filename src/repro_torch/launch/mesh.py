"""Production mesh construction.

Counterpart of ``src/repro/launch/mesh.py``. The meshes are
``torch.distributed.device_mesh.DeviceMesh``es over the default process
group, which the caller sets up first: for the dry run a fake group of
256 or 512 ranks (``fake_world``), which runs no collective and needs no
card. Single pod: (16, 16) = 256 ranks (data, model). Multi-pod: (2, 16,
16) = 512 ranks (pod, data, model); the ``pod`` axis is pure data
parallelism across pods.

The reference's ``axis_type_kwargs`` picks a JAX axis type and has no
counterpart here. Nothing is set up when this module is imported: the
reference's module-level ``XLA_FLAGS`` (512 host devices) has no
counterpart either.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.zoo import MeshInfo


@contextlib.contextmanager
def fake_world(world_size: int):
    """The default process group as a fake one of ``world_size`` ranks
    (this process rank 0) for the body, torn down after. Collectives on it
    return at once without moving data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a default process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """Whatever-fits mesh over the default group's ranks: n ranks ->
    (n / model, model) with axes (data, model)."""
    n = dist.get_world_size()
    data = max(1, n // model)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_info(mesh) -> MeshInfo:
    return MeshInfo(axis_names=tuple(mesh.mesh_dim_names),
                    axis_sizes={a: s for a, s in
                                zip(mesh.mesh_dim_names, mesh.shape)})
