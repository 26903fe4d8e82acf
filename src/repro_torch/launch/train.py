"""Fault-tolerant training loop: the port of ``repro.launch.train``.

Wires together: config -> data pipeline -> train step -> checkpoint /
restore -> recovery loop -> straggler monitor. Reduced configs run end to
end on the CPU (``device="cpu"``); ``--full`` trains the full-width
config on the GPU:

  python -m repro_torch.launch.train --arch gemma_2b --steps 25
  python -m repro_torch.launch.train --full --optimizer adafactor \\
      --seq-len 4096 --global-batch 1 --steps 3

runs on the CUDA device (``--device cpu`` runs the plain PyTorch path).
The step is eager; its attention runs forward through the flash kernel
and backward through the plain recompute
(``kernels.flash_attention.FlashAttentionFn``). Checkpoints hold bfloat16
parameters as float32 (``checkpoint_tree``).

A ``mesh_shape`` (data, model) other than (1, 1) trains over data ·
model ranks of a process group, one call of :func:`train` on each
(``--mesh 2,2`` spawns them: gloo on the CPU, NCCL with one rank per
GPU): every rank makes the same state and batch from the seed, keeps
its shards (``distribute_state`` by ``train_state_shardings``) and runs
the step under ``use_rules(mesh)``. A checkpoint holds whole tensors
(rank 0 writes it), so a run restores under any mesh: the reference's
elastic resharding, through ``restore_checkpoint(shardings=)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import configs as CFG
from repro_torch._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.data import SyntheticLMData
from repro_torch.distributed.fault import (FaultInjector, StepMonitor,
                                           run_with_recovery)
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.step import (
    checkpoint_tree, distribute_state, init_train_state, make_train_step,
    restore_shardings, train_state_from_tree, train_state_shapes,
    train_state_shardings)
from repro_torch.models import reduced
from repro_torch.optim import AdamW, Adafactor, cosine_warmup

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainRunConfig:
    arch: str = "qwen3_8b"
    use_reduced: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 64
    vocab_size: Optional[int] = 512      # reduced-vocab override (None = arch)
    lr: float = 3e-3
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    keep: int = 3
    compress_grads: bool = False
    optimizer: str = "adamw"
    mesh_shape: tuple = (1, 1)           # (data, model)
    seed: int = 0
    d_model: int = 128
    layers: int = 4


def build(run: TrainRunConfig):
    """The run's config (reduced and float32 unless ``use_reduced`` is
    off), optimizer and data, as the reference builds them."""
    cfg = CFG.get(run.arch)
    if run.use_reduced:
        cfg = reduced(cfg, layers=run.layers, d_model=run.d_model,
                      heads=max(4, run.d_model // 32), ff=run.d_model * 4)
        cfg = dataclasses.replace(cfg, dtype="float32")
        if run.vocab_size:
            cfg = dataclasses.replace(cfg, vocab_size=run.vocab_size)
    sched = cosine_warmup(run.lr, run.warmup, run.steps)
    if run.optimizer == "adafactor":
        opt = Adafactor(learning_rate=sched)
    else:
        opt = AdamW(learning_rate=sched, keep_master=False)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                           seed=run.seed)
    return cfg, opt, data


def train(run: TrainRunConfig, fault: Optional[FaultInjector] = None,
          on_metrics: Optional[Callable[[int, Dict[str, Any]], None]] = None,
          device: DeviceLike = DEFAULT_DEVICE):
    """Returns (final_state, history). Fault-tolerant when ckpt_dir is set:
    a failed step restarts from the latest checkpoint. ``on_metrics(step,
    metrics)`` sees each step's ``loss`` and ``grad_norm`` tensors."""
    dev = resolve_device(device)
    cfg, opt, data = build(run)
    mesh, shardings = None, None
    if tuple(run.mesh_shape) != (1, 1):
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(*run.mesh_shape, device=dev)
        shardings = train_state_shardings(cfg, opt, mesh,
                                          compress_grads=run.compress_grads)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    step_fn = make_train_step(cfg, opt, compress_grads=run.compress_grads)
    ckpt = AsyncCheckpointer(run.ckpt_dir, keep=run.keep) \
        if run.ckpt_dir and rank0 else None
    monitor = StepMonitor()
    history: List[Dict[str, Any]] = []
    state_box: Dict[str, Any] = {"state": None}

    def restore_point() -> int:
        state_box["state"] = None            # free the failed state first
        if not run.ckpt_dir or latest_step(run.ckpt_dir) is None:
            state = init_train_state(cfg, opt, run.seed,
                                     compress_grads=run.compress_grads,
                                     device=dev)
            state_box["state"] = (state if mesh is None
                                  else distribute_state(state, shardings))
            return 0
        step = latest_step(run.ckpt_dir)
        target = train_state_shapes(cfg, opt, run.compress_grads)
        tree = restore_checkpoint(
            run.ckpt_dir, step, target, device=dev,
            shardings=None if mesh is None
            else restore_shardings(shardings, target))
        state_box["state"] = train_state_from_tree(cfg, tree)
        log.info("restored checkpoint at step %d", step)
        return step

    def save(step: int, state) -> None:
        tree = checkpoint_tree(state)       # every rank: it gathers shards
        if ckpt is not None:
            ckpt.save(step, tree)

    def loop(start: int) -> int:
        state = state_box["state"]
        with SH.use_rules(mesh):
            for step in range(start, run.steps):
                if fault is not None:
                    fault.maybe_fail(step)
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(dev) for k, v in
                         data.batch(step, run.global_batch).items()}
                if mesh is not None:
                    bsh = batch_layout(cfg, batch, mesh)
                    batch = {k: SH.distribute(v, bsh[k])
                             for k, v in batch.items()}
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                monitor.record(step, time.perf_counter() - t0)
                history.append({"step": step, "loss": loss})
                if on_metrics:
                    on_metrics(step, metrics)
                if run.ckpt_dir and (step + 1) % run.ckpt_every == 0:
                    save(step + 1, state)
                state_box["state"] = state
        if run.ckpt_dir:
            if ckpt is not None:
                ckpt.wait()
            save(run.steps, state_box["state"])
            if ckpt is not None:
                ckpt.wait()
            if mesh is not None:
                torch.distributed.barrier()
        return run.steps

    if run.ckpt_dir:
        run_with_recovery(loop, restore_step=restore_point, max_restarts=5)
    else:
        restore_point()
        loop(0)
    return state_box["state"], history


def batch_layout(cfg, batch: Dict[str, torch.Tensor], mesh):
    """The batch's shardings for its own shape (``batch_shardings``)."""
    from repro_torch.distributed.step import batch_shardings
    from repro_torch.models import ShapeConfig

    b, s = batch["labels"].shape
    return batch_shardings(cfg, ShapeConfig("batch", s, b, "train"), mesh)


def train_rank(run: TrainRunConfig, device: DeviceLike = DEFAULT_DEVICE):
    """One rank of a mesh run (the entry :func:`main` spawns): its
    history, and its parameters' placements and gathered values by
    name."""
    state, history = train(run, device=device)
    params = {}
    for name, p in state["params"].named_parameters():
        full = p.full_tensor() if SH.is_dtensor(p) else p
        params[name] = (tuple(str(pl) for pl in getattr(p, "placements",
                                                         ())),
                        full.detach().cpu())
    return {"history": history, "params": params}


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--full", action="store_true",
                    help="use the full-width config (bfloat16, on the GPU)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model: train over data·model spawned ranks")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    run = TrainRunConfig(arch=args.arch, use_reduced=not args.full,
                         steps=args.steps, global_batch=args.global_batch,
                         seq_len=args.seq_len, lr=args.lr,
                         ckpt_dir=args.ckpt_dir, d_model=args.d_model,
                         layers=args.layers,
                         compress_grads=args.compress_grads,
                         optimizer=args.optimizer,
                         mesh_shape=tuple(int(n) for n in
                                          args.mesh.split(",")))
    t0 = time.perf_counter()
    if run.mesh_shape != (1, 1):
        from repro_torch.distributed.spawn import spawn

        history = spawn(train_rank, run.mesh_shape[0] * run.mesh_shape[1],
                        args=(run, dev.type), device=dev)[0]["history"]
    else:
        _, history = train(run, device=dev)
    print(f"first loss {history[0]['loss']:.4f} -> final "
          f"{history[-1]['loss']:.4f} in {time.perf_counter() - t0:.1f}s "
          f"on {dev}")


if __name__ == "__main__":
    main()
