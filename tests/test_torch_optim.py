"""Port parity, optimizers: the schedule, AdamW, Adafactor, int8 error
feedback and the MoE load-balancing loss against the JAX package, and the
port's twins of the reference's optimizer tests.

The updates run on a reduced model of two layers in one block, so that
each reference leaf (stacked ``[2, ...]``) is a group of two of the
port's per-layer tensors; gradients are numpy-seeded and scaled so that
the global-norm clip (AdamW) and the update clipping (Adafactor) are
active. Tolerances:

* schedule: 2 float32 ulps (``cos`` of two libraries);
* AdamW, float32 moments and master weights: max |port - reference| <=
  1e-5 · max |reference| per leaf; both compute in float32 with the same
  operations, but the global norm's float32 sum runs in another order and
  torch fuses ``b·m + (1 - b)·g`` into one rounding;
* bfloat16 parameters: equal but for at most 1e-3 of the elements, which
  lie at most one bfloat16 ulp (2^-7 of the value) apart per step: a step
  whose float32 update lies on a rounding boundary rounds it either way,
  and without the master copy the next step starts from the rounded
  value (observed: 1-4 elements of 65,536, 1-2 ulps after three steps);
* Adafactor: 1e-5 · max |reference| per leaf (the RMS's float32 sum runs
  in another order);
* error feedback: identical (the same float32 operations on the same
  inputs);
* ``moe_aux_loss`` and its router gradient: rtol 1e-6, atol 1e-7.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as RO
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.models import reduced as r_reduced
from repro.optim import compress as RCP
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch import optim as TO
from repro_torch.models import layers as TL
from repro_torch.models import reduced


def _model(dtype="float32", arch="qwen3_8b", **kw):
    kw = {**dict(layers=2, d_model=128, heads=4, ff=256), **kw}
    r = dataclasses.replace(r_reduced(RC.get(arch), **kw), dtype=dtype)
    t = dataclasses.replace(reduced(TC.get(arch), **kw), dtype=dtype)
    params = r_init_params(r, jax.random.PRNGKey(0))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), t, device="cpu")
    return r, t, params, model


def _grads(params, seed, scale=1.0, layer_scale=None):
    """numpy float32 gradients shaped like the reference's ``params``,
    with norm ``scale`` times the leaf count's root (clip active);
    ``layer_scale[r]`` scales repeat r of every stacked leaf."""
    rng = np.random.default_rng(seed)

    def one(path, p):
        g = rng.standard_normal(p.shape).astype(np.float32) * scale
        if layer_scale is not None and path[0].key == "blocks":
            g *= np.asarray(layer_scale, np.float32).reshape(
                (-1,) + (1,) * (g.ndim - 1))
        return g
    return jax.tree_util.tree_map_with_path(one, params)


def _as_ref(g, params):
    return jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, params)


def _as_port(g, t, model):
    flat = convert.port_leaves(g, t)
    return {n: torch.from_numpy(flat[n]).to(p.dtype)
            for n, p in model.named_parameters()}


def _close_tree(port_flat, ref_tree, t, rel, what, bf16_steps=0):
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.reference_tree(port_flat, t)))
    for path, want in jax.tree_util.tree_leaves_with_path(ref_tree):
        want = np.asarray(want, np.float32)
        g = np.asarray(got[path], np.float32)
        assert g.shape == want.shape, (what, path)
        diff = np.abs(g - want)
        if bf16_steps:
            assert (diff <= bf16_steps * 2.0 ** -7 * np.abs(want)).all() \
                and (diff > 0).mean() <= 1e-3, (what, path, diff.max())
        else:
            assert diff.max() <= rel * max(np.abs(want).max(), 1e-30), (
                what, path, diff.max())


def test_cosine_warmup_matches_reference():
    """Warm-up, peak, decay and the floor after the last step, in
    float32."""
    port, ref = TO.cosine_warmup(3e-3, 10, 100), RO.cosine_warmup(3e-3, 10,
                                                                 100)
    for step in (0, 1, 5, 10, 11, 37, 64, 99, 100, 250):
        got, want = port(step), np.float32(ref(jnp.asarray(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("keep_master", [True, False])
def test_adamw_matches_reference(keep_master):
    """Three clipped steps on bfloat16 parameters, with and without the
    float32 master copy: parameters, moments, master and step; and
    ``clip_by_global_norm`` alone on the first step's bf16 gradients."""
    r, t, params, model = _model("bfloat16")
    ropt = RO.AdamW(learning_rate=RO.cosine_warmup(1e-2, 2, 10),
                    keep_master=keep_master)
    topt = TO.AdamW(learning_rate=TO.cosine_warmup(1e-2, 2, 10),
                    keep_master=keep_master)
    rstate, tstate = ropt.init(params), topt.init(model)
    assert set(tstate) == set(rstate)
    for step in range(3):
        g = _grads(params, step, scale=0.05)
        assert float(RO.adamw.global_norm(_as_ref(g, params))) > 1.0
        if step == 0:   # the clip alone: bf16 gradients scaled, rounded back
            _close_tree(TO.clip_by_global_norm(_as_port(g, t, model), 1.0,
                                               TO.leaf_groups(model)),
                        RO.adamw.clip_by_global_norm(_as_ref(g, params),
                                                     1.0), t, 0, "clipped",
                        bf16_steps=1)
        params, rstate = ropt.update(_as_ref(g, params), rstate, params)
        model, tstate = topt.update(_as_port(g, t, model), tstate, model)
    assert int(tstate["step"]) == int(rstate["step"]) == 3
    _close_tree(dict(model.named_parameters()), params, t, 0, "params",
                bf16_steps=3)
    for key in ("mu", "nu") + (("master",) if keep_master else ()):
        _close_tree(tstate[key], rstate[key], t, 1e-5, key)


def test_adafactor_matches_reference():
    """Two steps, factored (the MLP, embedding and head: both trailing
    dims >= 128) and unfactored leaves (attention, norms), with update
    clipping active in the second: the second step's gradients are 20x
    the first's in layer 0 and 1/20 in layer 1, so the stacked leaves'
    RMS exceeds the threshold."""
    r, t, params, model = _model()
    ropt = RO.Adafactor(learning_rate=0.01)
    topt = TO.Adafactor(learning_rate=0.01)
    rstate, tstate = ropt.init(params), topt.init(model)
    v = tstate["v"]
    assert set(v["layers.0.ffn.wi_gate"]) == {"vr", "vc"}
    assert set(v["embed"]) == {"vr", "vc"}
    assert set(v["layers.1.mixer.wq"]) == {"v"}
    for step, layer_scale in enumerate([None, (20.0, 0.05)]):
        g = _grads(params, step, layer_scale=layer_scale)
        params, rstate = ropt.update(_as_ref(g, params), rstate, params)
        model, tstate = topt.update(_as_port(g, t, model), tstate, model)
    _close_tree(dict(model.named_parameters()), params, t, 1e-5, "params")
    flat = {f"{n}.{k}": x for n, d in tstate["v"].items()
            for k, x in d.items()}
    _close_tree(flat, rstate["v"], t, 1e-5, "v")


def test_per_layer_clipping_differs_from_grouped():
    """The same two Adafactor steps with each per-layer tensor clipped on
    its own (the parameters as a dict: no groups) miss the reference by
    far more than the grouped update's tolerance; AdamW's per-layer global
    norm is the same sum, so only its float32 order differs."""
    r, t, params, model = _model()
    ropt, topt = RO.Adafactor(learning_rate=0.01), \
        TO.Adafactor(learning_rate=0.01)
    per_layer = {n: p.detach().clone() for n, p in model.named_parameters()}
    rstate, tstate = ropt.init(params), topt.init(per_layer)
    for step, layer_scale in enumerate([None, (20.0, 0.05)]):
        g = _grads(params, step, layer_scale=layer_scale)
        params, rstate = ropt.update(_as_ref(g, params), rstate, params)
        per_layer, tstate = topt.update(_as_port(g, t, model), tstate,
                                        per_layer)
    got = convert.reference_tree(per_layer, t)
    want = params["blocks"][0][0]["mixer"]["wq"]
    err = np.abs(np.asarray(got["blocks"][0][0]["mixer"]["wq"])
                 - np.asarray(want)).max()
    assert err > 100 * 1e-5 * np.abs(np.asarray(want)).max(), err


def test_error_feedback_compress_matches_reference():
    """Three rounds with the error carried: the scale is the stacked
    leaf's (one per group), codes, decompressed gradients and errors are
    identical to the reference's; ``quantize_int8`` of one tensor too."""
    r, t, params, model = _model()
    groups = TO.leaf_groups(model)
    rerr = terr = None
    for step in range(3):
        g = _grads(params, 10 + step, layer_scale=(3.0, 0.2))
        rdec, rerr = RCP.error_feedback_compress(_as_ref(g, params), rerr)
        tdec, terr = TO.error_feedback_compress(_as_port(g, t, model), terr,
                                                groups)
        _close_tree(tdec, rdec, t, 0, "decompressed")
        _close_tree(terr, rerr, t, 0, "errors")
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    rq, rs = RCP.quantize_int8(jnp.asarray(x))
    tq, ts = TO.quantize_int8(torch.from_numpy(x))
    assert (tq.numpy() == np.asarray(rq)).all() and float(ts) == float(rs)
    assert torch.equal(TO.dequantize_int8(tq, ts),
                       torch.from_numpy(np.asarray(
                           RCP.dequantize_int8(rq, rs))))


def test_moe_aux_loss_matches_reference():
    """The Switch-style loss of an MoE layer and its gradient in the
    router, against the reference's on the same tokens."""
    r, t, params, model = _model(arch="phi35_moe", d_model=64, ff=128)
    x = np.random.default_rng(1).standard_normal((2, 24, 64)).astype(
        np.float32)
    rp = jax.tree.map(lambda a: a[0], params["blocks"][0][0]["ffn"])
    want, wgrad = jax.value_and_grad(
        lambda router: RL.moe_aux_loss({**rp, "router": router},
                                       jnp.asarray(x), r))(rp["router"])
    moe = model.layers[0].ffn
    moe.router.requires_grad_(True)
    got = TL.moe_aux_loss(moe, torch.from_numpy(x), t)
    (ggrad,) = torch.autograd.grad(got, moe.router)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(ggrad.numpy(), np.asarray(wgrad), rtol=1e-6,
                               atol=1e-7)


def _quadratic_descends(opt, steps=120, compress=False):
    target = {"w": torch.tensor([3.0, -2.0, 0.5]), "b": torch.tensor(1.5)}
    params = {"w": torch.zeros(3, requires_grad=True),
              "b": torch.zeros((), requires_grad=True)}
    state, err = opt.init(params), None

    def loss(p):
        return torch.sum((p["w"] - target["w"]) ** 2) + (p["b"]
                                                         - target["b"]) ** 2

    for _ in range(steps):
        grads = dict(zip(params, torch.autograd.grad(loss(params),
                                                     list(params.values()))))
        if compress:
            grads, err = TO.error_feedback_compress(grads, err)
        params, state = opt.update(grads, state, params)
    return float(loss(params))


def test_twins_of_the_reference_optimizer_tests():
    """``tests/test_optim.py`` on the port: both optimizers descend a
    quadratic, AdamW keeps a float32 master of bfloat16 parameters,
    Adafactor's factored state is small, the int8 round trip and the
    error feedback are bounded, compressed training tracks uncompressed,
    and the schedule's end points."""
    assert _quadratic_descends(TO.AdamW(learning_rate=0.1,
                                        weight_decay=0.0)) < 1e-2
    assert _quadratic_descends(TO.Adafactor(learning_rate=0.3,
                                            weight_decay=0.0)) < 0.3
    assert _quadratic_descends(TO.AdamW(learning_rate=0.1, weight_decay=0.0),
                               steps=80, compress=True) < 1e-2
    opt = TO.AdamW(learning_rate=0.05, weight_decay=0.0, keep_master=True)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["master"]["w"].dtype == torch.float32
    new_p, _ = opt.update({"w": torch.ones(4, dtype=torch.bfloat16)}, state,
                          params)
    assert new_p["w"].dtype == torch.bfloat16
    st = TO.Adafactor().init({"big": torch.zeros(256, 512),
                              "small": torch.zeros(4, 4)})
    assert set(st["v"]["big"]) == {"vr", "vc"} and set(st["v"]["small"]) \
        == {"v"} and st["v"]["big"]["vr"].shape == (256,)
    sch = TO.cosine_warmup(1e-3, 10, 100)
    assert float(sch(0)) == 0.0 and abs(float(sch(10)) - 1e-3) < 1e-9 \
        and float(sch(100)) < 2e-4
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    q, s = TO.quantize_int8(x)
    assert float((TO.dequantize_int8(q, s) - x).abs().max()) <= float(s) / 2 \
        + 1e-6
    rng = np.random.default_rng(1)
    true_sum, applied, err = np.zeros(64), np.zeros(64), None
    for _ in range(200):
        g = {"g": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
        true_sum += g["g"].numpy()
        dec, err = TO.error_feedback_compress(g, err)
        applied += dec["g"].numpy()
    assert np.abs(applied - true_sum).max() < 0.5
