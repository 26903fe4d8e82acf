"""Production-mesh dry run: trace one step of every (arch × shape × mesh)
cell on one process, with no allocation.

The port of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's jitted step on 512 host devices. Here one process joins a
fake group of 256 or 512 ranks (``launch.mesh.fake_group``: its
collectives return at once), builds the production mesh on it, makes
rank 0's shards of the state and the inputs as DTensors of fake tensors
(``FakeTensorMode``: shapes, no memory), and runs the train or decode
step once. That run is:

  * proof of a coherent distribution config (every op of the step has a
    sharding and runs; ``shard_as`` constrains the model's activations);
  * ``MemTracker``'s peak of rank 0's memory (the counterpart of
    ``memory_analysis()``: parameters, gradients, optimizer state,
    activations and temporaries as the eager step holds them);
  * the cost counter's per-device flops, bytes and collectives
    (:mod:`repro_torch.analysis.cost`) and their roofline terms on H100s
    (:mod:`repro_torch.analysis.roofline`).

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys (``trace_s`` in place of ``lower_s`` and
``compile_s``). The fake tensors live on ``--device`` (CUDA by default:
the kernels' ops trace on CUDA tensors without launching; ``--device
cpu`` traces on a machine without a GPU):

  python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k \\
      --mesh single --device cpu
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

:func:`run_local_shard` runs one real rank of such a cell: rank 0's
shards of the state as real tensors on the device, a few train steps,
its time and peak memory. The other ranks do not exist, so collectives
move nothing and the loss is not a result; time and memory are.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from .. import configs as CFG
from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..analysis import cost as COST
from ..analysis import roofline as rl
from ..distributed import sharding as SH
from ..distributed import step as STEP
from ..models import SHAPES, ModelConfig, ShapeConfig
from ..optim import Adafactor, AdamW
from .mesh import _init_mesh, fake_group
from .specs import input_specs

# Giant models: factored second moments (AdamW state would not fit).
ADAFACTOR_ARCHS = {"deepseek_v3", "jamba15_large"}

# Optimization profiles (the reference's):
#   * the expert-parallel MoE for the MoE archs
#   * gemma: MQA head_dim TP is a pessimization — the 8-head attention
#     runs data-parallel only
OPT_PROFILES = {
    "deepseek_v3": ({"moe_impl": "ep"}, None),
    "phi35_moe": ({"moe_impl": "ep"}, None),
    "jamba15_large": ({"moe_impl": "ep"}, None),
    "gemma_2b": (None, {"head_dim_tp": None}),
}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def make_optimizer(arch: str):
    if arch in ADAFACTOR_ARCHS:
        return Adafactor(learning_rate=1e-3)
    return AdamW(learning_rate=1e-3, keep_master=True)


def _mesh_layout(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    """(shape, dim names, name) of the production mesh, or of
    ``mesh_shape`` (2 dims: ("data", "model"); 3: ("pod", "data",
    "model"))."""
    shape = tuple(mesh_shape) if mesh_shape else \
        ((2, 16, 16) if multi_pod else (16, 16))
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return shape, names, "x".join(str(n) for n in shape)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _peak_tracker():
    """PyTorch's ``MemTracker`` keeping only the device-wide peak: after
    each op it also walks every module it has seen to update the module's
    own peak, which no one reads here and which made a 61-layer cell's
    trace several times slower."""
    from torch.distributed._tools import mem_tracker as MT

    class PeakTracker(MT.MemTracker):
        def _update_peak_stats(self, peak_state) -> None:
            for dev, snap in self._curr_mem_snap.items():
                if self._peak_mem.get(dev, 0) < snap[MT._TOTAL_KEY]:
                    self._peak_mem[dev] = snap[MT._TOTAL_KEY]
                    self._peak_mem_snap[dev] = dict(snap)

    return PeakTracker()


def _step_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, optimizer,
                 rule_overrides, dev, seed: Optional[int]):
    """(step function, its arguments) of the cell on this rank's shards:
    the train step with its state and batch, or the decode step with the
    parameters, a full cache (position seq_len - 1) and one token. With
    ``seed`` None the shards are uninitialised (fake tensors); else the
    parameters are random and the tokens uniform over the vocab."""
    specs = input_specs(cfg, shape)
    b_shard = STEP.batch_shardings(cfg, shape, mesh, rule_overrides)
    fill = None
    if seed is not None:
        gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)

        def fill(dims, dtype, device):
            if dtype.is_floating_point:
                return torch.randn(dims, generator=gen, device=device).to(
                    dtype)
            return torch.randint(0, cfg.vocab_size, dims, generator=gen,
                                 device=device, dtype=dtype)

    if shape.kind == "decode":
        s_shard = STEP.train_state_shardings(cfg, optimizer, mesh,
                                             rule_overrides)
        # requiring grad (MemTracker hooks every parameter's gradient); the
        # decode step runs without grad
        params = STEP.init_sharded_params(cfg, s_shard["params"], seed,
                                          dev).requires_grad_(True)
        c_shard = STEP.cache_shardings(cfg, shape.global_batch,
                                       shape.seq_len, mesh, rule_overrides)
        cache = STEP.sharded_tree(
            STEP.cache_shapes(cfg, shape.global_batch, shape.seq_len),
            c_shard, dev, torch.zeros)
        cache["pos"] = shape.seq_len - 1
        inputs = STEP.sharded_tensor(b_shard["inputs"], specs["inputs"].shape,
                                     specs["inputs"].dtype, dev, fill)
        return STEP.make_decode_step(cfg), (params, cache, inputs)
    s_shard = STEP.train_state_shardings(cfg, optimizer, mesh, rule_overrides)
    state = STEP.init_sharded_train_state(cfg, optimizer, s_shard, seed, dev)
    batch = {k: STEP.sharded_tensor(b_shard[k], v.shape, v.dtype, dev, fill)
             for k, v in specs.items()}
    return STEP.make_train_step(cfg, optimizer), (state, batch)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             rule_overrides: Optional[Dict] = None, save: bool = True,
             tag: str = "", cfg_overrides: Optional[Dict] = None,
             device: DeviceLike = DEFAULT_DEVICE,
             mesh_shape: Optional[Sequence[int]] = None) -> Dict:
    """Trace one cell's step on rank 0 of a fake group over the production
    mesh (or ``mesh_shape``) and return (and with ``save`` write) its
    result: memory, per-device counts and roofline terms."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = CFG.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    dims, names, mesh_name = _mesh_layout(multi_pod, mesh_shape)
    chips = math.prod(dims)
    optimizer = make_optimizer(arch)
    dev = resolve_device(device)

    with fake_group(chips):
        mesh = _init_mesh(dev, dims, names)
        t0 = time.perf_counter()
        with FakeTensorMode(allow_non_fake_inputs=True), \
                SH.use_rules(mesh, rule_overrides):
            step, args = _step_inputs(cfg, shape, mesh, optimizer,
                                      rule_overrides, dev, None)
            tracker = _peak_tracker()
            tracker.track_external(*_tensors(args))
            with COST.quiet_shape_propagation(), tracker:
                stats = COST.analyze(step, *args)
        trace_s = time.perf_counter() - t0
    snaps = [snap for d, snap in tracker.get_tracker_snapshot("peak").items()
             if d.type == dev.type]
    mem = {str(getattr(k, "value", k)): int(v) for k, v in
           max(snaps, key=lambda sn: sn.get("Total", 0)).items()}
    per_dev_bytes = mem.get("Total")

    roof = rl.build(arch, shape, cfg, mesh_name, chips, stats, per_dev_bytes)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "trace_s": round(trace_s, 2),
        "memory_analysis": mem,
        "cost_analysis_flops": float(stats.flops),
        "cost_analysis_bytes": float(stats.bytes_proxy),
        "hlo_stats": stats.to_json(),
        "roofline": roof.to_json(),
    }
    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(OUT_DIR,
                            f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def run_local_shard(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_shape: Sequence[int] = (16, 16), steps: int = 3,
                    optimizer=None, rule_overrides: Optional[Dict] = None,
                    device: DeviceLike = DEFAULT_DEVICE, seed: int = 0,
                    on_step=None) -> Dict:
    """Rank 0 of a ``mesh_shape`` group, for real: its shards of the train
    state (random, from ``seed``) and of the batch on ``device``, then
    ``steps`` train steps. The other ranks are fake, so collectives move
    nothing and the loss is not a result. Returns each step's seconds (on
    CUDA between events), the peak memory allocated on the device
    (``None`` on the CPU) and the local batch's shape. ``on_step(i)`` is
    called after each step has finished."""
    dims, names, mesh_name = _mesh_layout(False, mesh_shape)
    dev = resolve_device(device)
    optimizer = optimizer or AdamW(learning_rate=1e-3, keep_master=True)
    with fake_group(math.prod(dims)):
        mesh = _init_mesh(dev, dims, names)
        with SH.use_rules(mesh, rule_overrides):
            step, (state, batch) = _step_inputs(
                cfg, shape, mesh, optimizer, rule_overrides, dev, seed)
            local_batch = tuple(batch["inputs"].to_local().shape)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for i in range(steps):
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    state, _ = step(state, batch)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    state, _ = step(state, batch)
                    times.append(time.perf_counter() - t0)
                if on_step is not None:
                    on_step(i)
            peak = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None)
    return {"mesh": mesh_name, "step_s": times, "peak_bytes": peak,
            "local_batch": local_batch}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--opt", action="store_true",
                    help="apply the optimization profiles (OPT_PROFILES)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device of the fake tensors: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.opt and not args.tag:
        args.tag = "opt"

    archs = CFG.registry() if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        shapes = CFG.shapes_for(arch) if args.shape == "all" \
            else [args.shape]
        for shape_name in shapes:
            for multi in meshes:
                mesh_name = "2x16x16" if multi else "16x16"
                out = os.path.join(OUT_DIR, f"{arch}__{shape_name}__"
                                   f"{mesh_name}"
                                   + (f"__{args.tag}" if args.tag else "")
                                   + ".json")
                if args.skip_existing and os.path.exists(out):
                    print(f"[skip] {arch} {shape_name} {mesh_name}")
                    continue
                label = f"{arch:16s} {shape_name:12s} {mesh_name}"
                cfg_over, rule_over = (OPT_PROFILES.get(arch, (None, None))
                                       if args.opt else (None, None))
                try:
                    t0 = time.perf_counter()
                    r = run_cell(arch, shape_name, multi, tag=args.tag,
                                 cfg_overrides=cfg_over,
                                 rule_overrides=rule_over,
                                 device=args.device)
                    roof = r["roofline"]
                    print(f"[ ok ] {label} trace={r['trace_s']:.0f}s "
                          f"mem/dev={roof['per_device_memory_gb']:.2f}GB "
                          f"terms(c/m/n)=({roof['compute_s']:.3f}/"
                          f"{roof['memory_s']:.3f}/"
                          f"{roof['collective_s']:.3f})s "
                          f"bottleneck={roof['bottleneck']} "
                          f"useful={roof['useful_ratio']:.2f} "
                          f"({time.perf_counter() - t0:.0f}s)")
                except Exception as e:  # noqa: BLE001 - reported, then exit 1
                    failures.append((label, repr(e)))
                    print(f"[FAIL] {label}: {e!r}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for lbl, err in failures:
            print(" ", lbl, err)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
