"""Run a function on N new processes joined in one process group.

    results = spawn(fn, 4, args=(...), device="cpu")    # gloo, 4 ranks
    results = spawn(fn, 2, args=(...), device="cuda")   # NCCL, GPUs 0 and 1

Each rank is a fresh interpreter (the ``spawn`` start method): it imports
``fn`` by its module path, so ``fn`` must be a module-level function of an
importable module that pulls in nothing the ranks should not load. The
ranks meet through a ``file://`` store in a temporary directory (no TCP
port, so several callers on one host never collide), and each process
group has a ``timeout``. The join has a deadline: a rank that raises makes
``spawn`` raise, and one that is still running at the deadline is killed
and ``spawn`` raises ``TimeoutError``. Either way every rank is gone when
``spawn`` returns.

On ``cuda`` the backend is NCCL with one rank per GPU (rank r on GPU r);
asking for more ranks than GPUs raises. There is no fallback to gloo or
to the CPU.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device


def backend_for(device_type: str) -> str:
    """The process-group backend for a device type: NCCL on CUDA, gloo on
    the CPU."""
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device type "
                     f"{device_type!r}")


def init_group(init_method: str, world_size: int, rank: int,
               device_type: str, timeout_s: float) -> None:
    """Join (or create) the default process group for ``device_type``;
    on CUDA, rank r takes GPU r of this host first."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(device_type), init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_entry(rank: int, world_size: int, init_method: str,
                device_type: str, timeout_s: float, fn: Callable,
                args: Sequence[Any], out_dir: str) -> None:
    """One rank: join the group, run ``fn(*args)``, save its result."""
    if device_type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_group(init_method, world_size, rank, device_type, timeout_s)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), *,
          device: DeviceLike = DEFAULT_DEVICE, timeout_s: float = 60.0,
          deadline_s: float = 3600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``nprocs`` new ranks of one process group and
    return each rank's result, in rank order.

    ``timeout_s`` is the process group's timeout (a collective that waits
    longer fails); ``deadline_s`` bounds the whole run, start-up included.
    Results travel through ``torch.save`` files in the run's temporary
    directory, so they may be tensors, numpy arrays and plain data.
    """
    import torch.multiprocessing as mp

    if nprocs < 1:
        raise ValueError(f"nprocs must be at least 1, got {nprocs}")
    dev = resolve_device(device)
    if dev.type == "cuda" and nprocs > torch.cuda.device_count():
        raise RuntimeError(
            f"{nprocs} NCCL ranks need {nprocs} GPUs (one rank per GPU); "
            f"this host has {torch.cuda.device_count()}")
    backend_for(dev.type)
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_entry, nprocs=nprocs, join=False, start_method="spawn",
            args=(nprocs, init_method, dev.type, timeout_s, fn, tuple(args),
                  tmp))
        stop = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.0, min(1.0,
                                                    stop - time.monotonic()))):
                if time.monotonic() >= stop:
                    raise TimeoutError(f"{nprocs} ranks still running after "
                                       f"{deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
