"""ProbGraph on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors the JAX package's layout (``core``, ``engine``,
``kernels``, ``obs``, ``launch``) and keeps its public names. It imports
``torch`` and ``numpy`` only. Entry points run on ``device="cuda"`` unless
the caller asks for the CPU, and raise when no CUDA device is present
rather than falling back to it.

Sketch words are stored as int32 bit patterns of the reference's uint32
words (``.view(torch.int32)``): torch's uint32 lacks shifts, ``~`` and
``index_select`` on the CPU.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
