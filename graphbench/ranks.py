"""A cell's ranks: one process per card, joined in one process group.

A cell whose ``chips`` is k > 1 runs as k ranks; rank r runs on ``cuda:r``
(NCCL), or on the CPU with gloo for the tests. ``launch`` starts them with
the ``spawn`` method, joined through a ``file://`` store in a temporary
directory, and returns what rank 0's function returned. The run has a
deadline: a rank that raises, dies or is still running at the deadline
makes ``launch`` raise :class:`RankFailure`, and no rank is left alive.
A cell of one card starts no process and no group: :class:`Group` then
answers every collective itself.

This is the benchmark's own launcher, independent of the program's
``repro_torch.distributed.spawn``, so the yardstick does not rest on the
code under test.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds a launched run may take, start-up, compilation and check
#: included (the first run of a checkout compiles the program's kernels)
DEADLINE_S = 1100.0


class RankFailure(RuntimeError):
    """A rank raised, died or outlived the run's deadline."""


class Group:
    """This process's place among the cell's ranks and the few collectives
    the harness makes; alone (world 1) each answers without a call."""

    def __init__(self, device: torch.device):
        self.device = device
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def barrier(self) -> None:
        """Returns once every rank has reached it (the host waits on the
        device's reduction, whatever the backend)."""
        if self.world > 1:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t)
            t.item()

    def broadcast_rows(self, rows: Optional[torch.Tensor], src: int
                       ) -> torch.Tensor:
        """Rank ``src``'s ``rows`` (int64[r, 2], on this rank's device), on
        every rank; the others pass None."""
        if self.world == 1:
            return rows
        size = torch.tensor([rows.shape[0] if self.rank == src else 0],
                            device=self.device)
        dist.broadcast(size, src)
        if self.rank != src:
            rows = torch.empty((int(size), 2), dtype=torch.int64,
                               device=self.device)
        dist.broadcast(rows, src)
        return rows

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0)
        return out


def _rank_main(rank: int, world: int, store: str, device_type: str,
               timeout_s: float, fn: Callable, args: Sequence[Any],
               out: str) -> None:
    cuda = device_type == "cuda"
    # the ranks share the host's cores (gloo ranks are the CPU tests')
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world) if cuda
                          else 2)
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=store, world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    result = fn(torch.device(device_type, rank) if cuda
                else torch.device("cpu"), *args)
    if rank == 0:
        torch.save(result, out)
    # only after success, and once every rank is done with the group: a
    # rank that raised exits at once, and a peer that leaves a gloo group
    # early can abort the ranks still using it
    dist.barrier(device_ids=[rank] if cuda else None)
    dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence[Any] = (), *,
           device: str = "cuda") -> Any:
    """``fn(device, *args)`` on ``world`` new ranks of one process group,
    within ``DEADLINE_S``; returns rank 0's result. ``fn`` is a
    module-level function, and it and ``args`` are pickled to each rank."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    deadline_s = DEADLINE_S
    device_type = torch.device(device).type
    tmp = tempfile.mkdtemp(prefix="graphbench_ranks_")
    out = os.path.join(tmp, "rank0.pt")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(world, "file://" + os.path.join(tmp, "store"), device_type,
                  deadline_s, fn, tuple(args), out))
        stop = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, stop - time.monotonic())), grace_period=5.0):
                if time.monotonic() >= stop:
                    raise RankFailure(f"{world} ranks still running after "
                                      f"{deadline_s} s")
        except ProcessException as err:
            raise RankFailure(f"a rank failed: {err}\n"
                              + _errors(ctx.error_files)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            _errors(ctx.error_files)
        return torch.load(out, weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        _stop_resource_tracker()


def _errors(paths: Sequence[str]) -> str:
    """The last line of each rank's saved traceback (the first failure
    may be a peer's lost connection); the files are removed."""
    lines = []
    for rank, path in enumerate(paths):
        if os.path.exists(path):
            with open(path, "rb") as fh:
                lines.append(f"rank {rank}: "
                             + pickle.load(fh).strip().splitlines()[-1])
            os.remove(path)
    return "\n".join(lines)


def _stop_resource_tracker() -> None:
    """Ends the helper process that ``spawn`` starts beside the ranks
    (multiprocessing starts it again should anything need it)."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
