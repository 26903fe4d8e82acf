"""Port parity, the dry run: ``launch.dryrun.run_cell`` on reduced dense,
expert-parallel MoE (with Adafactor and MLA), SSM and hybrid configs, on
fake (2, 2) and (2, 2, 2) groups, and ``launch.specs.input_specs``
against the JAX package's.

A cell traces one step on rank 0 of a fake group with fake tensors (no
allocation). Its result carries the reference's keys (``trace_s`` for
``lower_s`` and ``compile_s``), a positive memory estimate and roofline
terms that are its counts over the H100 constants. The cells use the
shapes of ``SHAPES`` at reduced width; the SSM cell's chunk is 512, so
the 4,096 positions of ``train_4k`` make 8 chunks.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as RC
from repro.launch.specs import input_specs as r_input_specs
from repro_torch import configs as TC
from repro_torch.analysis import roofline as R
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.models import SHAPES, reduced

REF_KEYS = {"arch", "shape", "mesh", "tag", "memory_analysis",
            "cost_analysis_flops", "cost_analysis_bytes", "hlo_stats",
            "roofline"}

CELLS = [
    ("qwen3_8b", "train_4k", (2, 2), {}),
    ("qwen3_8b", "decode_32k", (2, 2, 2), {}),
    ("deepseek_v3", "train_4k", (2, 2), {"moe_impl": "ep"}),
    ("phi35_moe", "train_4k", (2, 2, 2), {"moe_impl": "ep"}),
    ("mamba2_130m", "train_4k", (2, 2), {"ssm_chunk": 512}),
    ("jamba15_large", "decode_32k", (2, 2, 2), {"moe_impl": "ep"}),
]


def _overrides(arch, extra):
    cfg = dataclasses.replace(reduced(TC.get(arch)), dtype="float32",
                              **extra)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch,shape,mesh,extra", CELLS,
                         ids=[f"{a}-{s}-{'x'.join(map(str, m))}"
                              for a, s, m, _ in CELLS])
def test_run_cell(arch, shape, mesh, extra):
    r = dryrun.run_cell(arch, shape, cfg_overrides=_overrides(arch, extra),
                        save=False, device="cpu", mesh_shape=mesh)
    assert REF_KEYS <= set(r) and "trace_s" in r
    assert "lower_s" not in r and "compile_s" not in r
    assert r["mesh"] == "x".join(map(str, mesh)) and r["trace_s"] > 0
    mem = r["memory_analysis"]
    assert mem["Total"] > 0 and mem["Activation"] + mem["Temp"] > 0
    roof, stats = r["roofline"], r["hlo_stats"]
    assert roof["chips"] == (8 if len(mesh) == 3 else 4)
    assert stats["flops"] > 0 and stats["bytes_proxy"] > 0
    assert r["cost_analysis_flops"] == stats["flops"]
    assert roof["compute_s"] == pytest.approx(stats["flops"]
                                              / R.PEAK_FLOPS_BF16)
    assert roof["memory_s"] == pytest.approx(stats["bytes_proxy"] / R.HBM_BW)
    assert roof["collective_s"] == pytest.approx(
        stats["collective_link_bytes"] / R.LINK_BW)
    assert roof["per_device_memory_gb"] == pytest.approx(mem["Total"]
                                                         / 2 ** 30)
    assert stats["collective_link_bytes"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    opt = dryrun.make_optimizer(arch)
    assert type(opt).__name__ == ("Adafactor" if arch in
                                  dryrun.ADAFACTOR_ARCHS else "AdamW")


def test_input_specs_match_reference():
    """Every cell's stand-in inputs have the reference's shapes and
    dtypes, on ``meta``."""
    dtypes = {jnp.dtype("int32"): torch.int32,
              jnp.dtype("bfloat16"): torch.bfloat16,
              jnp.dtype("float32"): torch.float32}
    for arch in TC.registry():
        for shape_name in TC.shapes_for(arch):
            want = r_input_specs(RC.get(arch), SHAPES[shape_name])
            got = input_specs(TC.get(arch), SHAPES[shape_name])
            assert sorted(got) == sorted(want), (arch, shape_name)
            for k, v in want.items():
                assert tuple(got[k].shape) == tuple(v.shape)
                assert got[k].dtype == dtypes[jnp.dtype(v.dtype)]
                assert got[k].is_meta


def test_dry_run_entry_points_need_a_gpu_unless_cpu():
    """``run_cell``, ``run_local_shard`` and the production mesh default
    to CUDA and raise without a GPU; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.models import ShapeConfig

    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("qwen3_8b", "decode_32k", save=False,
                        cfg_overrides=_overrides("qwen3_8b", {}),
                        mesh_shape=(2, 2))
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_local_shard(reduced(TC.get("qwen3_8b")),
                               ShapeConfig("t", 8, 4, "train"),
                               mesh_shape=(2, 2))
    with fake_group(256):
        with pytest.raises(RuntimeError, match="cuda"):
            make_production_mesh()
