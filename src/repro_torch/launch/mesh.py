"""Meshes over the ranks of the current process group.

Functions, not module constants, so that importing never touches the
process group. The production mesh is the JAX package's (a 16×16
("data", "model") mesh, or 2×16×16 with "pod" first) over 256 or 512
ranks: GPUs of a real group, or one rank of a fake group
(:func:`fake_group`) for the dry run, which needs no other rank.
"""
from __future__ import annotations

import contextlib

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device


def _init_mesh(device: DeviceLike, shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(repro_torch.distributed.spawn starts ranks in "
                           "one; launch.mesh.fake_group starts a fake one)")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = DEFAULT_DEVICE):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``, over the current group's 256 or
    512 ranks, on the device type of ``device``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(device, shape, names)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = DEFAULT_DEVICE):
    """A ("data", "model") ``DeviceMesh`` of shape (data, model) over the
    ranks of the initialized process group (data · model of them), on the
    device type of ``device`` (the group's backend must serve it: NCCL
    for CUDA, gloo for the CPU). Rank r sits at (r // model, r % model)."""
    return _init_mesh(device, (data, model), ("data", "model"))


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks of which this process is
    ``rank`` and the others do not exist: its collectives return at once
    and write nothing (their outputs hold whatever memory held). Meshes
    and DTensors build on it as on a real group, so one process can trace
    a step of a 256- or 512-rank job with that rank's shapes. The group
    is destroyed on exit.

    The fake backend is PyTorch's own test utility
    (``torch.testing._internal.distributed.fake_pg``), the one place the
    port imports ``torch.testing._internal``; torchtitan uses it the same
    way for its dry runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group needs a process without a group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
