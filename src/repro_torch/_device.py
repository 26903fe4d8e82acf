"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]

#: the device every entry point uses unless the caller names another
DEFAULT_DEVICE = "cuda"


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for ``device``; raises if it is CUDA and absent.

    There is no silent CPU fallback: a caller that wants the plain PyTorch
    path on the CPU passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(value) -> None:
    """Wait for the device work behind ``value`` when it is a CUDA tensor."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)
