"""Meshes over the ranks of the current process group.

A function, not a module constant, so that importing never touches the
process group. The production TPU mesh of the JAX package (a 16×16
torus) comes with the port of the models.
"""
from __future__ import annotations

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = DEFAULT_DEVICE):
    """A ("data", "model") ``DeviceMesh`` of shape (data, model) over the
    ranks of the initialized process group (data · model of them), on the
    device type of ``device`` (the group's backend must serve it: NCCL
    for CUDA, gloo for the CPU). Rank r sits at (r // model, r % model)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process "
                           "group (repro_torch.distributed.spawn starts "
                           "ranks in one)")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))
