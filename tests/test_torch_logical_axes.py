"""Port parity, the logical-axes trees and the step's shardings: every
parameter, cache and optimizer-state spec of the ten configs at full
width, on the production mesh shapes (16×16 and 2×16×16), against the
JAX package's.

Nothing is allocated: the reference's shapes come from ``jax.eval_shape``,
the port's from ``meta`` tensors. The reference stacks each block's
layers into one leaf with a leading "layers" axis (mapped to no mesh
dim); the port keeps one tensor per layer, so a port spec is the
reference leaf's spec without its first entry (all specs identical).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as RC
from repro import models as RMOD
from repro import optim as RO
from repro.distributed import sharding as RSH
from repro.distributed import step as RSTEP
from repro_torch import configs as TC
from repro_torch import models as TMOD
from repro_torch import optim as TO
from repro_torch.distributed import sharding as TSH
from repro_torch.distributed import step as TSTEP
from repro_torch.models.model import Model
from repro_torch.optim.tree import leaf_groups

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _FakeMesh:
    """A mesh's shape only: enough for ``spec_for``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _ref_spec(axes, shape, mesh):
    return tuple(RSH.spec_for(axes, dim_sizes=tuple(shape), mesh=mesh))


def _port_spec(axes, shape, mesh):
    return TSH.spec_for(axes, dim_sizes=tuple(shape), mesh=mesh)


def _leaf_pairs(model):
    """(reference path, port name, stacked) for every port parameter."""
    for grp in leaf_groups(model):
        for name in grp.names:
            yield grp.path, name, grp.stacked


def _expect(ref_axes, ref_shape, port_axes, port_shape, stacked, mesh,
            what):
    want = _ref_spec(ref_axes, ref_shape, mesh)
    if stacked:
        assert want[0] is None, what
        want = want[1:]
    got = _port_spec(port_axes, port_shape, mesh)
    assert got == want, f"{what}: port {got} != reference {want}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_optimizer_state_specs(mesh_name):
    """Every parameter's spec, and every AdamW (``keep_master``) and
    Adafactor state tensor's, equals the reference leaf's."""
    mesh = _FakeMesh(*MESHES[mesh_name])
    for arch in TC.registry():
        rcfg, tcfg = RC.get(arch), TC.get(arch)
        r_axes = RMOD.params_logical_axes(rcfg)
        r_shapes = RSTEP.param_shapes(rcfg)
        model = Model(tcfg, None, torch.device("meta"))
        t_axes = TMOD.params_logical_axes(tcfg)
        shapes = dict(model.named_parameters())
        pairs = list(_leaf_pairs(model))
        for path, name, stacked in pairs:
            _expect(_get(r_axes, path), _get(r_shapes, path).shape,
                    t_axes[name], shapes[name].shape, stacked, mesh,
                    f"{arch} {name}")
        # AdamW with the float32 master copy: each moment as its parameter
        r_opt = RO.AdamW(keep_master=True)
        t_opt = TO.AdamW(keep_master=True)
        r_ax = r_opt.state_logical_axes(r_axes, r_shapes)
        t_ax = t_opt.state_logical_axes(t_axes, model)
        assert set(t_ax) == set(r_ax) == {"mu", "nu", "master", "step"}
        for key in ("mu", "nu", "master"):
            for path, name, stacked in pairs:
                _expect(_get(r_ax[key], path), _get(r_shapes, path).shape,
                        t_ax[key][name], shapes[name].shape, stacked, mesh,
                        f"{arch} adamw {key} {name}")
        # Adafactor: factored where the reference leaf's shape is
        r_opt, t_opt = RO.Adafactor(), TO.Adafactor()
        r_ax = r_opt.state_logical_axes(r_axes, r_shapes)
        r_st = jax.eval_shape(r_opt.init, r_shapes)
        t_ax = t_opt.state_logical_axes(t_axes, model)
        t_st = t_opt.init(model)
        for path, name, stacked in pairs:
            r_v, t_v = _get(r_ax["v"], path), t_ax["v"][name]
            assert set(r_v) == set(t_v), f"{arch} {name}"
            for k in r_v:
                _expect(r_v[k], _get(r_st["v"], path)[k].shape, t_v[k],
                        t_st["v"][name][k].shape, stacked, mesh,
                        f"{arch} adafactor {k} {name}")
        assert r_ax["step"] == t_ax["step"] == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs(mesh_name):
    """Every cache tensor's spec, at each decode shape of the arch, equals
    the reference's stacked cache leaf's; the position is replicated."""
    mesh = _FakeMesh(*MESHES[mesh_name])
    for arch in TC.registry():
        rcfg, tcfg = RC.get(arch), TC.get(arch)
        sigs = [sig for blk in RMOD.build_plan(rcfg)
                for _ in range(blk.repeat) for sig in blk.sigs]
        slots = [(b, si) for b, blk in enumerate(RMOD.build_plan(rcfg))
                 for _ in range(blk.repeat) for si in range(len(blk.sigs))]
        r_axes = RMOD.cache_logical_axes(rcfg)
        t_axes = TMOD.cache_logical_axes(tcfg)
        assert t_axes["pos"] == r_axes["pos"] == ()
        assert len(t_axes["layers"]) == len(sigs)
        for shape_name in TC.shapes_for(arch):
            shape = TMOD.SHAPES[shape_name]
            if shape.kind != "decode":
                continue
            r_shapes = RSTEP.cache_shapes(rcfg, shape.global_batch,
                                          shape.seq_len)
            t_shapes = TSTEP.cache_shapes(tcfg, shape.global_batch,
                                          shape.seq_len)
            for i, (b, si) in enumerate(slots):
                for key, axes in t_axes["layers"][i].items():
                    _expect(r_axes["blocks"][b][si][key],
                            r_shapes["blocks"][b][si][key].shape, axes,
                            t_shapes["layers"][i][key].shape, True, mesh,
                            f"{arch} {shape_name} layer {i} {key}")


def test_every_parameter_has_one_axes_tuple():
    """The axes tree names each parameter of the model once and nothing
    else, and each tuple has one entry per dim."""
    for arch in TC.registry():
        cfg = TC.get(arch)
        model = Model(cfg, None, torch.device("meta"))
        axes = TMOD.params_logical_axes(cfg)
        shapes = dict(model.named_parameters())
        assert sorted(axes) == sorted(shapes), arch
        for name, ax in axes.items():
            assert _is_axes(ax) and len(ax) == shapes[name].dim(), \
                (arch, name, ax)


def test_batch_and_logits_shardings():
    """``batch_shardings`` and ``logits_sharding`` equal the reference's
    for every shape of every arch on both meshes; ``replicated`` is the
    empty spec."""
    for dims, names in MESHES.values():
        r_mesh = AbstractMesh(dims, names)
        t_mesh = _FakeMesh(dims, names)
        for arch in TC.registry():
            rcfg, tcfg = RC.get(arch), TC.get(arch)
            for shape_name in TC.shapes_for(arch):
                shape = TMOD.SHAPES[shape_name]
                want = RSTEP.batch_shardings(rcfg, shape, r_mesh)
                got = TSTEP.batch_shardings(tcfg, shape, t_mesh)
                assert sorted(got) == sorted(want), (arch, shape_name)
                for k in want:
                    assert got[k].spec == tuple(want[k].spec), \
                        (arch, shape_name, k)
                seq = 1 if shape.kind == "decode" else shape.seq_len
                want = RSTEP.logits_sharding(rcfg, r_mesh,
                                             shape.global_batch, seq)
                got = TSTEP.logits_sharding(tcfg, t_mesh,
                                            shape.global_batch, seq)
                assert got.spec == tuple(want.spec), (arch, shape_name)
        assert TSTEP.replicated(t_mesh).spec == () == tuple(
            RSTEP.replicated(r_mesh).spec)


def test_shard_as_is_identity_without_mesh():
    """Without an active mesh, and on a plain tensor under one,
    ``shard_as`` returns its argument itself."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert TSH.shard_as(x, "batch", "seq", "embed_act") is x
    with TSH.use_rules(_FakeMesh((2, 2), ("data", "model"))):
        assert TSH.shard_as(x, "batch", "seq", "embed_act") is x
    assert TSH.active_mesh() is None
