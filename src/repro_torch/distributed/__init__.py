"""Distribution over ranks of ``torch.distributed``: the logical-axis
sharding rules (``sharding``) and the helper that starts N ranks in one
process group (``spawn``). Processes take the place of the JAX package's
devices: a mesh is a ``DeviceMesh`` over the ranks of the process group,
one GPU per rank on CUDA (NCCL), one process per rank on the CPU (gloo).
The train and decode steps (``step``) and fault tolerance (``fault``)
are imported from their modules: ``step`` imports the models, which
import ``sharding``.
"""
from . import sharding
from .spawn import spawn

__all__ = ["sharding", "spawn"]
