"""Port parity, the train loss: ``loss_fn`` and the gradient of every
parameter against ``jax.value_and_grad(repro.models.loss_fn)``, one case
per family, float32, reduced configs.

The reference's ``init_params`` tree is carried into the port
(``convert.model_params_from_numpy``); tokens, labels (and M-RoPE
positions) come from numpy under a seed. The port's per-layer gradients
are stacked back onto the reference's leaves (``convert.reference_tree``).
Remat is on (the configs' default) on both sides; the port's attention
gradient comes from ``FlashAttentionFn``'s plain recompute. Tolerances:

* the loss: rtol 1e-5 (observed <= 2e-7);
* each gradient leaf: max |port - reference| <= 1e-4 · max |reference|
  of that leaf (observed <= 5e-6): float32 on both sides, sums in another
  order (one matmul per projection against XLA's einsums, the plain
  recompute against the differentiated online softmax).

S <= 2,048 (the reference's attention raises at other S > 2,048:
ROADMAP reference fault 8).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import init_params as r_init_params
from repro.models import loss_fn as r_loss_fn
from repro.models import reduced as r_reduced
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import loss_fn, reduced


@pytest.mark.parametrize("arch,s", [("qwen3_8b", 64), ("gemma_2b", 48),
                                    ("h2o_danube3_4b", 160),
                                    ("qwen2_vl_72b", 48), ("phi35_moe", 48),
                                    ("deepseek_v3", 48), ("mamba2_130m", 64),
                                    ("jamba15_large", 48)])
def test_loss_and_gradients_match_reference(arch, s):
    """qk-norm and GQA; MQA, GELU and the tied head; a window of 64 over
    160 positions; M-RoPE with distinct (t, h, w) positions over
    embeddings; MoE in every layer; MLA, a dense layer then MoE with a
    shared expert; SSM over 8 chunks; the hybrid (attention + MLP, then SSM
    + MoE)."""
    kw = {"kv": 1} if arch == "gemma_2b" else {}
    r = dataclasses.replace(r_reduced(RC.get(arch), **kw), dtype="float32")
    t = dataclasses.replace(reduced(TC.get(arch), **kw), dtype="float32")
    assert t.remat
    params = r_init_params(r, jax.random.PRNGKey(0))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), t, device="cpu").requires_grad_()
    rng = np.random.default_rng(s)
    b = 2
    if t.input_mode == "tokens":
        x = rng.integers(0, t.vocab_size, (b, s)).astype(np.int32)
    else:
        x = (rng.standard_normal((b, s, t.d_model)) * 0.1).astype(np.float32)
    batch = {"inputs": x,
             "labels": rng.integers(0, t.vocab_size, (b, s)).astype(np.int32)}
    if t.rope_kind == "mrope":
        batch["positions"] = rng.integers(0, 4 * s, (b, s, 3)).astype(
            np.int32)
    want, wgrads = jax.value_and_grad(lambda p: r_loss_fn(
        p, r, jax.tree.map(jnp.asarray, batch)))(params)
    names, tensors = zip(*model.named_parameters())
    got = loss_fn(model, t, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    grads = torch.autograd.grad(got, tensors)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    port = dict(jax.tree_util.tree_leaves_with_path(
        convert.reference_tree(dict(zip(names, grads)), t)))
    leaves = jax.tree_util.tree_leaves_with_path(wgrads)
    assert len(leaves) == len(port)
    for path, w in leaves:
        w, g = np.asarray(w), port[path]
        assert g.shape == w.shape, path
        err = float(np.abs(g - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (arch, path, err)
