"""Port parity, the MoE layer over a mesh: the expert-parallel
``moe_fwd_ep`` and the sharded ``moe_fwd``, on 4 gloo ranks, against the
JAX package.

The reference's ``moe_fwd_ep`` runs in a subprocess on 4 host devices
(``XLA_FLAGS``) under a hand-built ``Mesh`` of Auto axes: on
``jax.make_mesh``'s Explicit axes its model code cannot constrain
activations (ROADMAP reference fault 11). The port's ranks run
``distributed.report.moe_report`` on the same numpy weights and inputs.
Its capacity is per data shard, C_loc = ceil(t_loc·k/E·cf), so its drops
differ from ``moe_fwd``'s; the test inputs make them differ, and the port
must drop exactly what the reference drops.

Tolerances (float32): outputs within 1e-5 · max |reference| (the
partials are summed over the "model" ranks in another order; one
different drop would move a row by O(1)); gradients, against the port's
one-process autograd of the same function (``moe_fwd`` on each data
shard's tokens for the expert-parallel layer), within 1e-5 · max |grad|.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import reduced as r_reduced
from repro_torch import configs as TC
from repro_torch.distributed import spawn
from repro_torch.distributed.report import moe_report
from repro_torch.models import layers as TL
from repro_torch.models import reduced

B, S = 4, 16
ARCHS = ("phi35_moe", "deepseek_v3")

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs as RC
from repro.distributed import sharding as SH
from repro.models import reduced
from repro.models.moe_ep import moe_fwd_ep
data = np.load(sys.argv[2], allow_pickle=True)
out = {}
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for arch in sys.argv[4].split(","):
    cfg = dataclasses.replace(reduced(RC.get(arch)), dtype="float32")
    p = {}
    for k in data.files:
        if k.startswith(arch + "/"):
            parts = k.split("/")[1:]
            d = p
            for q in parts[:-1]:
                d = d.setdefault(q, {})
            d[parts[-1]] = jnp.asarray(data[k])
    x = jnp.asarray(data["x/" + arch])
    with SH.use_rules(mesh):
        out[arch] = np.asarray(jax.jit(lambda p, x: moe_fwd_ep(p, x, cfg))(p, x))
np.savez(sys.argv[3], **out)
"""


def _cfg(arch, **kw):
    return dataclasses.replace(reduced(TC.get(arch)), dtype="float32", **kw)


def _weights(cfg, seed):
    """Numpy weights under ``MoE``'s parameter names."""
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    router = w(d, e)
    router[0, 0] += 1.5   # with x's feature 0 raised: expert 0 is popular
    p = {"router": router, "wi_gate": w(e, d, ff), "wi_up": w(e, d, ff),
         "wo": w(e, ff, d)}
    if cfg.moe_shared_experts:
        sf = cfg.moe_d_ff * cfg.moe_shared_experts
        p.update({"shared.wi_gate": w(d, sf), "shared.wi_up": w(d, sf),
                  "shared.wo": w(sf, d)})
    return p


def _inputs(cfg, seed):
    """x (feature 0 raised, so the routing is skewed and capacity drops
    assignments) and the gradient probe."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x[..., 0] += 1.0
    return x, rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _layer(cfg, params):
    layer = TL.MoE(cfg, None, "cpu")
    for name, p in layer.named_parameters():
        p.data.copy_(torch.from_numpy(params[name]))
    return layer.requires_grad_(True)


def _one_process(cfg, params, x, probe, shards):
    """``moe_fwd`` over each of ``shards`` batch slices (one: the whole
    batch) in one process; its output and gradients of Σ y · probe."""
    layer = _layer(cfg, params)
    xt = torch.from_numpy(x).requires_grad_(True)
    ys = [TL.moe_fwd(layer, part, cfg) for part in xt.chunk(shards, 0)]
    y = torch.cat(ys)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(probe)).sum(),
                                [xt] + [p for _, p in
                                        layer.named_parameters()])
    return y.detach().numpy(), dict(zip(["x"] + names,
                                        (g.numpy() for g in grads)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    cases, data = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch, moe_impl="ep")
        params = _weights(cfg, 10 + i)
        x, probe = _inputs(cfg, 20 + i)
        cases[arch] = dict(mesh=((2, 2), ("data", "model")), cfg=cfg,
                           params=params, x=x, probe=probe)
        data.update({f"{arch}/{k.replace('.', '/')}": v
                     for k, v in params.items()})
        data["x/" + arch] = x
    base = cases["phi35_moe"]
    cases["gspmd"] = dict(base, cfg=_cfg("phi35_moe"))
    cases["no_model_dim"] = dict(base, mesh=((4,), ("data",)))
    odd = _cfg("phi35_moe", moe_impl="ep", moe_num_experts=6)
    cases["experts_not_divided"] = dict(
        base, mesh=((1, 4), ("data", "model")), cfg=odd,
        params=_weights(odd, 30))
    order = list(cases)
    port = dict(zip(order, spawn(moe_report, 4,
                                 args=([cases[k] for k in order], "cpu"),
                                 device="cpu", timeout_s=120)[0]))
    np.savez(tmp / "in.npz", **data)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, src, str(tmp / "in.npz"),
         str(tmp / "out.npz"), ",".join(ARCHS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    return cases, port, ref


def _close(got, want, what):
    tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |port - reference| {err} > {tol}"


def _reference_dense(cfg, params, x):
    """The reference's ``moe_fwd`` (capacity over the whole batch)."""
    import jax.numpy as jnp

    rcfg = dataclasses.replace(r_reduced(RC.get(cfg.name)), dtype="float32",
                               moe_num_experts=cfg.moe_num_experts)
    p = {}
    for k, v in params.items():
        if k.startswith("shared."):
            p.setdefault("shared", {})[k[7:]] = jnp.asarray(v)
        else:
            p[k] = jnp.asarray(v)
    return np.asarray(RL.moe_fwd(p, jnp.asarray(x), rcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_matches_reference(runs, arch):
    """The expert-parallel output equals the reference's ``moe_fwd_ep`` on
    a 2×2 mesh, whose local drops make it differ from ``moe_fwd``."""
    cases, port, ref = runs
    case = cases[arch]
    _close(port[arch]["y"], ref[arch], f"{arch} moe_fwd_ep")
    dense = _reference_dense(case["cfg"], case["params"], case["x"])
    assert np.abs(dense - ref[arch]).max() > 1e-2, \
        "the inputs must make the local capacity drop other assignments"


@pytest.mark.parametrize("arch", ARCHS)
def test_ep_gradients(runs, arch):
    """The expert-parallel layer's gradients (x and every weight) equal
    the one-process autograd of ``moe_fwd`` on each data shard."""
    cases, port, _ = runs
    case = cases[arch]
    y, grads = _one_process(case["cfg"], case["params"], case["x"],
                            case["probe"], shards=2)
    _close(port[arch]["y"], y, f"{arch} output")
    for name, g in grads.items():
        _close(port[arch]["grads"][name], g, f"{arch} d/d{name}")


def test_sharded_moe_fwd_matches_reference(runs):
    """``moe_fwd`` (``moe_impl="gspmd"``) on a 2×2 mesh keeps the whole
    batch's capacity: the reference's ``moe_fwd``, and the one-process
    port's gradients."""
    cases, port, _ = runs
    case = cases["gspmd"]
    _close(port["gspmd"]["y"],
           _reference_dense(case["cfg"], case["params"], case["x"]),
           "sharded moe_fwd")
    _, grads = _one_process(case["cfg"], case["params"], case["x"],
                            case["probe"], shards=1)
    for name, g in grads.items():
        _close(port["gspmd"]["grads"][name], g, f"d/d{name}")


def test_ep_falls_back_to_moe_fwd(runs):
    """Without a "model" mesh dim, or when it does not divide the experts
    (6 experts over 4), ``moe_fwd_ep`` is ``moe_fwd``: the capacity over
    the whole batch, as the reference's ``moe_fwd``."""
    cases, port, _ = runs
    for key in ("no_model_dim", "experts_not_divided"):
        case = cases[key]
        _close(port[key]["y"],
               _reference_dense(case["cfg"], case["params"], case["x"]),
               key)
