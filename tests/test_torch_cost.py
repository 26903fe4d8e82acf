"""Port parity, the cost source and the roofline: the per-device counts of
``analysis.cost`` (flops, collectives) against the JAX package's HLO
analysis, the H100 roofline terms and the live gauges.

Counterparts of the reference's ``tests/test_sharding.py`` (a dot's
flops, the all-reduce ring model) and ``tests/test_obs.py`` (the
roofline gauges). The train step's per-device flops are held against the
reference's compiled step on 4 host devices (a subprocess with
``XLA_FLAGS`` and a hand-built Auto ``Mesh``: ROADMAP reference fault
11), source by source. Outside the attention core (the projections, the
gated MLP, the LM head, each with its remat recompute: both sides
recompute a layer's forward except its last MLP product, whose output
the backward does not need) the counts are equal. The attention core
differs by design: the port counts the kernel's forward (and its remat
recompute) over the causal pairs it keeps, 4·D flops a pair, and its
plain backward's 6 products over the whole S × S square; the
reference's chunked attention counts every product over the square (9
per layer in XLA's step). For the reduced ``qwen3_8b`` step that is
8,421,376 against 9,437,184 flops, and the port's whole step counts
5.6656e7 against the reference's 5.7672e7 (-1.76 %).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import configs as TC
from repro_torch.analysis import cost, live
from repro_torch.analysis import roofline as R
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import step as STEP
from repro_torch.launch.mesh import _init_mesh, fake_group
from repro_torch.models import SHAPES, ShapeConfig, reduced
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import AdamW

_REFERENCE_STEP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs as RC
from repro.analysis import hlo
from repro.distributed import sharding as SH
from repro.distributed import step as STEP
from repro.launch.specs import input_specs
from repro.models import ShapeConfig, reduced
from repro.optim import AdamW
cfg = dataclasses.replace(reduced(RC.get("qwen3_8b")), dtype="float32")
shape = ShapeConfig("t", 64, 4, "train")
opt = AdamW(learning_rate=1e-3, keep_master=True)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
with SH.use_rules(mesh):
    s_sh = STEP.train_state_shardings(cfg, opt, mesh)
    b_sh = STEP.batch_shardings(cfg, shape, mesh)
    b_sds = input_specs(cfg, shape)
    step = jax.jit(STEP.make_train_step(cfg, opt),
                   in_shardings=(s_sh, {k: b_sh[k] for k in b_sds}),
                   out_shardings=(s_sh, None))
    compiled = step.lower(STEP.train_state_shapes(cfg, opt), b_sds).compile()
stats = hlo.analyze(compiled.as_text())
# the attention's products carry no op_name: their keys are XLA's names
print("FLOPS=", stats.flops, "ATTENTION=", sum(
    v for k, v in stats.dot_flops_by_meta.items() if "/" not in k))
"""


def test_matmul_counts_two_mnk():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    stats = cost.analyze(lambda: a @ b)
    assert stats.flops == 2 * 64 * 128 * 32
    # inputs read once, output written once (float32)
    assert stats.bytes_proxy == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert stats.while_trip_counts == []


def test_dtensor_matmul_counts_local_flops_once():
    """A DTensor matmul on a fake 16×16 group counts rank 0's local
    product once (not the global one DTensor infers shapes with)."""
    with fake_group(256):
        mesh = _init_mesh("cpu", (16, 16), ("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(256, 4096, 4096), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(4096, 12288), mesh,
                                  [Replicate(), Shard(1)])
            stats = cost.analyze(lambda: x @ w)
    assert stats.flops == 2 * (256 // 16) * 4096 * 4096 * (12288 // 16)
    assert stats.collective_ops == {}


def test_collective_bytes_ring_model():
    """An all-reduce of 1,024 float32 over 4 ranks: 4,096 payload bytes
    and 2·(g-1)/g of them over the link; an all-gather and a
    reduce-scatter (g-1)/g of their larger side."""
    with fake_group(4):
        group = dist_group()
        t = torch.ones(1024)
        stats = cost.analyze(
            lambda: funcol.all_reduce(t, "sum", group).wait())
        assert stats.collective_bytes == {"all-reduce": 4096}
        assert stats.collective_ops == {"all-reduce": 1}
        assert stats.collective_link_bytes == pytest.approx(2 * 3 / 4 * 4096)
        stats = cost.analyze(lambda: (
            funcol.all_gather_tensor(t, 0, group).wait(),
            funcol.reduce_scatter_tensor(t, "sum", 0, group).wait()))
    assert stats.collective_bytes == {"all-gather": 4 * 4096,
                                      "reduce-scatter": 4096}
    assert stats.collective_link_bytes == pytest.approx(
        3 / 4 * 4 * 4096 + 3 / 4 * 4096)


def dist_group():
    import torch.distributed as dist

    return dist.group.WORLD


def test_roofline_terms_with_h100_constants():
    stats = cost.OpStats(flops=R.PEAK_FLOPS_BF16, bytes_proxy=R.HBM_BW,
                         collective_link_bytes=R.LINK_BW)
    roof = R.build("qwen3_8b", SHAPES["train_4k"], TC.get("qwen3_8b"),
                   "16x16", 256, stats, per_device_memory_bytes=2 ** 31)
    assert (R.PEAK_FLOPS_BF16, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12,
                                                         50e9)
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.memory_s == pytest.approx(1.0)
    assert roof.collective_s == pytest.approx(1.0)
    assert roof.bottleneck in ("compute", "memory", "collective")
    assert roof.per_device_memory_gb == pytest.approx(2.0)
    mf = (R.model_flops(TC.get("qwen3_8b"), SHAPES["train_4k"])
          + R.attention_flops(TC.get("qwen3_8b"), SHAPES["train_4k"]))
    assert roof.useful_ratio == pytest.approx(mf / (R.PEAK_FLOPS_BF16 * 256))


def test_record_roofline_gauges():
    a = torch.ones(64, 64)
    reg = MetricsRegistry()
    out = live.record_roofline("matmul", lambda: a @ a, wall_s=1e-3,
                               registry=reg)
    assert out["flops"] == 2 * 64 ** 3
    assert out["bound_s"] == pytest.approx(max(
        out["flops"] / R.PEAK_FLOPS_BF16, out["bytes_proxy"] / R.HBM_BW))
    assert out["fraction"] == pytest.approx(out["bound_s"] / 1e-3)
    assert reg.value("roofline_fraction", op="matmul") == out["fraction"]
    assert reg.value("roofline_bound_s", op="matmul") == out["bound_s"]
    again = live.record_roofline("matmul", live.op_cost(lambda: a @ a),
                                 wall_s=1e-3, registry=reg)
    assert again == out


def test_train_step_flops_against_reference():
    """The reduced ``qwen3_8b`` train step's per-device flops on a fake
    2×2 group against the reference's compiled step on 4 host devices:
    equal outside the attention core, the core as its kernel forward and
    plain backward count, the total within 2 % (observed -1.76 %)."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_STEP, src],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    words = proc.stdout.split()
    want = float(words[words.index("FLOPS=") + 1])
    want_attention = float(words[words.index("ATTENTION=") + 1])
    assert 0 < want_attention < want

    cfg = dataclasses.replace(reduced(TC.get("qwen3_8b")), dtype="float32")
    shape = ShapeConfig("t", 64, 4, "train")
    opt = AdamW(learning_rate=1e-3, keep_master=True)
    with fake_group(4):
        mesh = _init_mesh("cpu", (2, 2), ("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True), \
                SH.use_rules(mesh):
            sh = STEP.train_state_shardings(cfg, opt, mesh)
            state = STEP.init_sharded_train_state(cfg, opt, sh, seed=None,
                                                  device="cpu")
            bsh = STEP.batch_shardings(cfg, shape, mesh)
            batch = {k: STEP.sharded_tensor(bsh[k], (4, 64), torch.int32,
                                            "cpu")
                     for k in ("inputs", "labels")}
            stats = cost.analyze(STEP.make_train_step(cfg, opt), state,
                                 batch)
    by_module = stats.dot_flops_by_meta
    assert sum(by_module.values()) == stats.flops
    core = sum(v for k, v in by_module.items() if k.endswith("mixer.core"))
    assert stats.flops - core == want - want_attention
    # per layer and device: 2 of 4 sequences, 2 of 4 heads
    b, h, s, d = 2, cfg.num_heads // 2, shape.seq_len, cfg.head_dim
    forward = 4 * b * h * d * s * (s + 1) // 2        # the causal pairs
    square = 2 * b * h * s * s * d                    # one S × S product
    assert core == cfg.num_layers * (2 * forward + 6 * square)
    assert abs(stats.flops / want - 1) < 0.02, (stats.flops, want)
    mf = (R.model_flops(cfg, shape) + R.attention_flops(cfg, shape)) / 4
    assert stats.flops >= mf
    assert stats.collective_ops["all-gather"] > 0
    assert stats.collective_ops["all-reduce"] > 0
