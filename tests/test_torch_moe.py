"""Port parity, MoE: ``models.layers.moe_fwd`` and its routing against the
JAX package's ``moe_fwd``; the expert-parallel switch; the converter's
float32 leaves in a bf16 model.

Reduced float32 configs (4 experts, top-2; deepseek_v3 with its shared
expert); inputs from numpy under a seed; the reference's ``init_moe``
weights loaded into the port's module. Tolerances:

* the layer's output: max |port - reference| <= 1e-4 · max(max
  |reference|, 1), as the model tests (float32 sums in another order);
* routing: the expert ids, each assignment's rank within its expert, the
  kept and dropped assignments and their slots are **identical**. The
  reference's routing is its own lines of ``moe_fwd`` (softmax, ``top_k``,
  stable ``argsort``, segment counts), run in jax on the reference's
  router logits.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as RC
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import reduced as r_reduced
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import reduced


def _configs(arch, **kw):
    r = dataclasses.replace(r_reduced(RC.get(arch)), dtype="float32", **kw)
    t = dataclasses.replace(reduced(TC.get(arch)), dtype="float32", **kw)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    return r, t


def _moe_pair(arch, seed=0, **kw):
    r, t = _configs(arch, **kw)
    rp = RL.init_moe(r, jax.random.PRNGKey(seed))[0]
    moe = TL.init_moe(t, None, "cpu")
    flat = {}
    convert._dotted(jax.tree.map(np.asarray, rp), "", flat)
    moe.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in flat.items()})
    return r, t, rp, moe


def _reference_routing(rp, x, cfg):
    """The routing lines of the reference's ``moe_fwd``, in jax."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 1)
    xt = jnp.asarray(x).reshape(t, -1)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), rp["router"])
    gates, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    e_flat = idx.reshape(t * k)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = jnp.take(e_flat, order)
    counts = jax.ops.segment_sum(jnp.ones_like(e_sorted, jnp.int32),
                                 e_sorted, num_segments=e)
    starts = jnp.cumsum(counts) - counts
    rank_sorted = jnp.arange(t * k, dtype=jnp.int32) - jnp.take(starts,
                                                                e_sorted)
    rank = jnp.zeros((t * k,), jnp.int32).at[order].set(rank_sorted)
    keep = rank < cap
    dest = jnp.where(keep, e_flat * cap + rank, e * cap)
    return cap, *(np.asarray(a) for a in (idx, rank, keep, dest))


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(float(np.abs(want).max()), 1.0), (what, err)


@pytest.mark.parametrize("arch", ["phi35_moe", "deepseek_v3"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_fwd_and_routing_match_reference(arch, capacity_factor):
    """The layer's output within tolerance, its routing identical: at the
    configs' default capacity factor and at 0.5, where assignments are
    dropped (the drop slot is discarded on both sides)."""
    r, t, rp, moe = _moe_pair(arch, seed=1, capacity_factor=capacity_factor)
    assert ("shared" in rp) == (arch == "deepseek_v3") == hasattr(moe,
                                                                 "shared")
    assert moe.router.dtype == torch.float32
    x = (np.random.default_rng(2).standard_normal((2, 64, t.d_model))
         .astype(np.float32))
    _close(TL.moe_fwd(moe, torch.from_numpy(x), t).numpy(),
           RL.moe_fwd(rp, jnp.asarray(x), r), arch)

    cap, idx, rank, keep, dest = _reference_routing(rp, x, r)
    got = TL.moe_route(moe, torch.from_numpy(x).reshape(128, -1), t)
    assert got.cap == cap == TL.moe_capacity(128, t)
    np.testing.assert_array_equal(got.idx.numpy(), idx)
    np.testing.assert_array_equal(got.rank.numpy(), rank)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.dest.numpy(), dest)
    if capacity_factor < 1:
        assert 0 < int((~keep).sum()) < keep.size
        assert (dest[~keep] == t.moe_num_experts * cap).all()
    gates = got.gates.numpy()
    np.testing.assert_allclose(gates.sum(-1), 1.0, rtol=1e-6)


def test_expert_parallel_switch():
    """``moe_impl="ep"``: without a mesh the reference's ``moe_fwd_ep``
    runs ``moe_fwd``, and so does the port (equal to the reference's
    ``_moe`` and to the port's own ``moe_fwd``, bit for bit); under a mesh
    the port's ``moe_fwd_ep`` takes DTensors, and on plain tensors it is
    ``moe_fwd`` too (the sharded layer: ``test_torch_moe_ep.py``)."""
    r, t, rp, moe = _moe_pair("deepseek_v3", seed=3, moe_impl="ep")
    x = (np.random.default_rng(4).standard_normal((2, 16, t.d_model))
         .astype(np.float32))
    got = TM._moe(moe, torch.from_numpy(x), t)
    _close(got.numpy(), RM._moe(rp, jnp.asarray(x), r), "ep")
    torch.testing.assert_close(got, TL.moe_fwd(moe, torch.from_numpy(x), t),
                               rtol=0, atol=0)
    with SH.use_rules(types.SimpleNamespace(shape={"data": 1, "model": 2})):
        torch.testing.assert_close(TM._moe(moe, torch.from_numpy(x), t), got,
                                   rtol=0, atol=0)
    with SH.use_rules(types.SimpleNamespace(shape={"data": 2})):
        torch.testing.assert_close(TM._moe(moe, torch.from_numpy(x), t), got,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["deepseek_v3", "jamba15_large"])
def test_bf16_model_keeps_float32_leaves(arch):
    """A bf16 reference model carried across: every weight keeps the
    reference leaf's type (the router, ``a_log``, ``d_skip`` and
    ``dt_bias`` float32, the rest bf16) and its values; hybrid plans of
    two blocks unstack in the reference's order."""
    r = r_reduced(RC.get(arch))
    t = reduced(TC.get(arch))
    assert r.dtype == t.dtype == "bfloat16"
    params = r_init_params(r, jax.random.PRNGKey(5))
    assert len(params["blocks"]) == 2
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), t, device="cpu")
    flat = {k: v for k, v in params.items() if k != "blocks"}
    for i, layer in enumerate(convert.unstack_layers(params["blocks"], t)):
        convert._dotted(layer, f"layers.{i}.", flat)
    state = model.state_dict()
    assert set(state) == set(flat)
    f32 = {name for name, a in flat.items() if a.dtype == np.float32}
    assert f32 and all(n.rsplit(".", 1)[1] in ("router", "a_log", "d_skip",
                                               "dt_bias") for n in f32)
    for name, w in state.items():
        want = np.asarray(flat[name])
        assert w.dtype == (torch.float32 if name in f32 else torch.bfloat16)
        np.testing.assert_array_equal(w.float().numpy(),
                                      want.astype(np.float32), err_msg=name)
