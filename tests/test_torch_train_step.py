"""Port parity, the train step: the flash attention's gradient, remat, one
``make_train_step`` step from a carried reference state, and the data
pipeline, against the JAX package.

Tolerances:

* attention gradients (``FlashAttentionFn``'s plain recompute against
  ``jax.vjp`` of ``chunked_causal_attention``): max |port - reference|
  <= 2e-5 · max |reference| per input (the reference's kernel tolerance,
  relative; observed <= 1e-6); the output within 2e-5 likewise;
* remat: gradients identical (the recomputed forward is the same float32
  arithmetic);
* one train step (float32, reduced ``qwen3_8b`` of 3 layers): loss and
  ``grad_norm`` rtol 1e-5 (observed <= 3e-7); Adafactor's parameters and
  moments within 1e-5 · max |reference| per leaf (observed <= 1.3e-6).
  AdamW's first update is lr · g / (|g| + 1e-8), which turns a gradient
  near 1e-8 and its float32 error into a visible step: parameters within
  0.1 · lr everywhere and within 1e-3 · lr on all but 1e-3 of each leaf
  (observed 0.048 · lr and 2e-4), moments within 1e-5 · max |reference|.
  With int8 error feedback a gradient lying within its float32 error of a
  rounding boundary takes the other code, which moves its error by one
  quantization step and its AdamW update by up to lr (0 against ±1
  codes): parameters within 1.1 · lr everywhere, and on all but 1e-3 of
  each leaf the parameters within 1e-3 · lr, the moments within 1e-3 ·
  max |reference| and the errors within 1e-3 of 2 · max |reference|
  (about one quantization step) (observed: 2e-5 to 4e-5 of the elements
  flip);
* data: identical arrays.
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
from repro.data import SyntheticLMData as RData
from repro.data import TokenBatcher as RBatcher
from repro.distributed.step import init_train_state as r_init_train_state
from repro.distributed.step import make_train_step as r_make_train_step
from repro.models import layers as RL
from repro.models import reduced as r_reduced
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch import optim as TO
from repro_torch.data import SyntheticLMData, TokenBatcher
from repro_torch.distributed.step import make_train_step
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_folded)
from repro_torch.models import init_params, loss_fn, reduced
from repro_torch.models.layers import AttentionCore


@pytest.mark.parametrize("case", ["gqa", "window", "mla"])
def test_flash_gradient_matches_reference(case):
    """GQA over S = 4,096 (two of the backward's blocks and two of the
    reference's chunks; the folded layout's gradient too), a window of 96
    over 640 positions, and MLA's narrow v (head dim 24 against 40)
    through ``AttentionCore``, which pads it for the kernel; output
    gradient random."""
    b, s, h, kv, d, dv, window = {
        "gqa": (1, 4096, 4, 2, 16, 16, 0),
        "window": (2, 640, 4, 1, 32, 32, 96),
        "mla": (2, 256, 4, 4, 40, 24, 0)}[case]
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kv))
    v = rng.standard_normal((b, s, kv, dv)).astype(np.float32)
    dout = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: RL.chunked_causal_attention(
        *a, window=window), *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = (AttentionCore(window)(tq, tk, tv) if case == "mla"
           else flash_attention(tq, tk, tv, window=window))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for what, g, w in [("out", out.detach(), want)] + list(
            zip("qkv", grads, wgrads)):
        w = np.asarray(w)
        assert g.shape == w.shape, what
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 2e-5 * float(np.abs(w).max()), (case, what, err)
    if case == "gqa":
        fq, fk, fv = (x.detach()[0].transpose(0, 1).requires_grad_()
                      for x in (tq, tk, tv))
        fout = flash_attention_folded(fq, fk, fv, groups=h // kv)
        fgrads = torch.autograd.grad(fout, (fq, fk, fv),
                                     torch.from_numpy(dout)[0].transpose(0, 1))
        assert torch.equal(fout.detach(), out.detach()[0].transpose(0, 1))
        for fg, g in zip(fgrads, grads):
            assert torch.equal(fg, g[0].transpose(0, 1))


def test_remat_gradients_equal_and_recompute_the_forward():
    """With ``remat`` every layer's forward, its attention kernel call
    included, runs twice in a step (forward, then again in the backward),
    and the gradients equal those without remat bit for bit."""
    cfg = dataclasses.replace(reduced(TC.get("qwen3_8b"), layers=3),
                              dtype="float32")
    model = init_params(cfg, 0, device="cpu").requires_grad_()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48)))
             for k in ("inputs", "labels")}
    calls = []
    hooks = [layer.mixer.core.register_forward_hook(
        lambda *_: calls.append(1)) for layer in model.layers]
    grads = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        calls.clear()
        grads[remat] = torch.autograd.grad(loss_fn(model, c, batch),
                                           list(model.parameters()))
        assert len(calls) == cfg.num_layers * (2 if remat else 1), remat
    for h in hooks:
        h.remove()
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))


def _agree(got, want, what, loose, tight, frac):
    """|got - want| <= loose everywhere and <= tight on all but ``frac``
    of the elements."""
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.shape == np.shape(want), what
    assert diff.max() <= loose and (diff > tight).mean() <= frac, (
        what, diff.max(), (diff > tight).mean())


def _trees(port_flat, ref_tree, t):
    got = dict(jax.tree_util.tree_leaves_with_path(
        convert.reference_tree(port_flat, t)))
    return [(path, got[path], np.asarray(w)) for path, w in
            jax.tree_util.tree_leaves_with_path(ref_tree)]


@pytest.mark.parametrize("opt_name,compress", [("adamw", False),
                                               ("adafactor", False),
                                               ("adamw", True)])
def test_train_step_matches_reference(opt_name, compress):
    """The reference's ``init_train_state`` carried into the port
    (``convert.train_state_from_numpy``), one step on the same batch:
    loss, ``grad_norm``, parameters, optimizer state and errors."""
    kw = dict(layers=3, d_model=128, heads=4, ff=256)
    r = dataclasses.replace(r_reduced(RC.get("qwen3_8b"), **kw),
                            dtype="float32")
    t = dataclasses.replace(reduced(TC.get("qwen3_8b"), **kw),
                            dtype="float32")
    if opt_name == "adamw":
        def make(m):
            return m.AdamW(learning_rate=m.cosine_warmup(3e-3, 2, 10),
                           keep_master=False)
        lr = 1.5e-3                       # step 1 of the warm-up
    else:
        def make(m):
            return m.Adafactor(learning_rate=m.cosine_warmup(3e-2, 2, 10))
    rstate = r_init_train_state(r, make(RO), jax.random.PRNGKey(0),
                                compress_grads=compress)
    tstate = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, rstate), t, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, t.vocab_size, (2, 64)).astype(np.int32)
             for k in ("inputs", "labels")}
    rstate, rm = r_make_train_step(r, make(RO), compress)(
        rstate, jax.tree.map(jnp.asarray, batch))
    tstate, tm = make_train_step(t, make(TO), compress)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(rm[key]), rtol=1e-5)
    assert int(tstate["opt"]["step"]) == int(rstate["opt"]["step"]) == 1
    params = dict(tstate["params"].named_parameters())
    if opt_name == "adafactor":
        flat = {f"{n}.{k}": x for n, d in tstate["opt"]["v"].items()
                for k, x in d.items()}
        for tree, ref in ((params, rstate["params"]),
                          (flat, rstate["opt"]["v"])):
            for path, g, w in _trees(tree, ref, t):
                tol = 1e-5 * np.abs(w).max()
                _agree(g, w, path, tol, tol, 0)
        return
    for path, g, w in _trees(params, rstate["params"], t):
        _agree(g, w, path, 1.1 * lr if compress else 0.1 * lr, 1e-3 * lr,
               1e-3)
    for key in ("mu", "nu"):
        for path, g, w in _trees(tstate["opt"][key], rstate["opt"][key], t):
            unit = np.abs(w).max()
            if compress:
                _agree(g, w, (key, path), np.inf, 1e-3 * unit, 1e-3)
            else:
                _agree(g, w, (key, path), 1e-5 * unit, 1e-5 * unit, 0)
    if compress:
        for path, g, w in _trees(tstate["ef"], rstate["ef"], t):
            _agree(g, w, ("ef", path), np.inf, 2e-3 * np.abs(w).max(), 1e-3)


def test_data_pipeline_identical():
    """``SyntheticLMData`` batches (two seeds, two steps, the iterator) and
    ``TokenBatcher`` packing (padding of the last batch, no documents)."""
    for seed in (0, 3):
        ref, port = RData(97, 33, seed=seed), SyntheticLMData(97, 33,
                                                             seed=seed)
        for step in (0, 5):
            want, got = ref.batch(step, 4), port.batch(step, 4)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(
                    got[k], want[k])
        for want, got, _ in zip(ref.batches(2, 7), port.batches(2, 7),
                                range(2)):
            assert np.array_equal(got["inputs"], want["inputs"])
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 50, rng.integers(3, 40)) for _ in range(9)]
    for d in (docs, []):
        ref, port = RBatcher(d, 16, pad_id=0), TokenBatcher(d, 16, pad_id=0)
        assert port.num_batches(2) == ref.num_batches(2)
        for i in range(ref.num_batches(2) + 1):
            want, got = ref.batch(i, 2), port.batch(i, 2)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(
                    got[k], want[k])
