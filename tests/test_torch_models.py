"""Port parity, models: the decoders' layers, prefill forward and cached
decode step against the JAX package, for the dense, MoE, MLA, SSM and
hybrid configs.

Reduced float32 configs; inputs from numpy under a seed; the reference's
``init_params`` tree carried into the port by
``convert.model_params_from_numpy``. Tolerances:

* logits and caches (KV, MLA's compressed stream, SSM windows and
  state): max |port - reference| <= 1e-4 · max(max |reference|, 1).
  Both compute in float32 with sums in another order
  (one matmul per projection against XLA's einsums, the port's attention
  core against ``chunked_causal_attention``'s online softmax); observed
  about 1e-6 of max |logit|. The pad region of the vocab is -1e30 on both
  sides, exactly;
* layer functions (norm, RoPE, M-RoPE): rtol = atol = 1e-6, a few float32
  ulps (``pow``, ``sin``, ``cos`` of two libraries);
* the attention core: atol = rtol = 2e-5, the reference's kernel tolerance.

The reference's attention reshapes S into chunks of 2,048, so it raises at
S > 2,048 unless S is a multiple of 2,048 (ROADMAP reference fault 8): the
comparisons run at S <= 2,048 or at 4,096.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import decode_step as r_decode_step
from repro.models import forward as r_forward
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import layers as RL
from repro.models import reduced as r_reduced
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ref as TR
from repro_torch.models import (decode_step, forward, init_cache,
                                layers as TL, reduced)

#: per-arch arguments of ``reduced``: gemma keeps its single kv head (MQA)
REDUCE = {"gemma_2b": dict(kv=1)}


def _configs(arch, **kw):
    kw = {**REDUCE.get(arch, {}), **kw}
    r = dataclasses.replace(r_reduced(RC.get(arch), **kw), dtype="float32")
    t = dataclasses.replace(reduced(TC.get(arch), **kw), dtype="float32")
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    return r, t


def _models(arch, seed=0, **kw):
    r, t = _configs(arch, **kw)
    params = r_init_params(r, jax.random.PRNGKey(seed))
    model = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, params), t, device="cpu")
    return r, t, params, model


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        return x, torch.from_numpy(x).long()
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.1).astype(np.float32)
    return x, torch.from_numpy(x)


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(float(np.abs(want).max()), 1.0), (what, err)


def _close_logits(got, want, cfg, what=""):
    v = cfg.vocab_size
    _close(got[..., :v], want[..., :v], what)
    assert (np.asarray(got[..., v:]) == -1e30).all()
    assert (np.asarray(want[..., v:]) == np.float32(-1e30)).all()


@pytest.mark.parametrize("arch,b,s", [("qwen3_8b", 1, 4096),
                                      ("gemma_2b", 2, 96),
                                      ("h2o_danube3_4b", 2, 160),
                                      ("qwen2_vl_72b", 2, 48),
                                      ("phi35_moe", 2, 64),
                                      ("deepseek_v3", 2, 64),
                                      ("mamba2_130m", 2, 64),
                                      ("jamba15_large", 2, 64)])
def test_forward_matches_reference(arch, b, s):
    """Logits of the prefill forward: qk-norm and GQA at S = 4,096 (two of
    the reference's chunks); MQA, GELU and the tied head; a window of 64
    over 160 positions; M-RoPE with distinct (t, h, w) positions over
    embeddings; MoE in every layer; MLA, a dense layer then MoE with a
    shared expert; SSM over 8 chunks with the tied head; the hybrid
    (attention + MLP, then SSM + MoE)."""
    r, t, params, model = _models(arch)
    if arch == "gemma_2b":
        assert t.num_kv_heads == 1 and t.tie_embeddings and t.act == "gelu"
    x, tx = _inputs(t, b, s, seed=s)
    pos = tpos = None
    if t.rope_kind == "mrope":
        rng = np.random.default_rng(1)
        pos = rng.integers(0, 4 * s, (b, s, 3)).astype(np.int32)
        tpos = torch.from_numpy(pos)
    want = np.asarray(r_forward(params, r, jnp.asarray(x),
                                None if pos is None else jnp.asarray(pos)))
    got = forward(model, t, tx, tpos)
    assert got.dtype == torch.float32
    _close_logits(got.numpy(), want, t, arch)


@pytest.mark.parametrize("arch,steps,max_len", [("h2o_danube3_4b", 80, 96),
                                                ("musicgen_large", 24, 32),
                                                ("phi35_moe", 12, 16),
                                                ("deepseek_v3", 12, 16),
                                                ("mamba2_130m", 24, 32),
                                                ("jamba15_large", 12, 16)])
def test_decode_steps_and_caches_match_reference(arch, steps, max_len):
    """Teacher-forced decode: each step's logits, every layer's cache and
    the position equal the reference's; the window config decodes 80
    steps through its 64-slot ring buffer. Where no layer is an MoE, the
    port's decode also agrees with its own forward on the same inputs: an
    MoE's capacity depends on the tokens of the call, so its decode step
    (B tokens) and its forward (B·S tokens) drop other assignments, by the
    reference's design."""
    r, t, params, model = _models(arch, seed=1)
    b = 2
    x, tx = _inputs(t, b, steps, seed=7)
    step = jax.jit(lambda p, c, inp: r_decode_step(p, c, r, inp))
    r_cache = r_init_cache(r, b, max_len)
    cache = init_cache(t, b, max_len, device="cpu")
    if t.sliding_window:
        assert cache["layers"][0]["k"].shape == (b, 64, t.num_kv_heads,
                                                 t.head_dim)
    full = None if t.moe_num_experts else forward(model, t, tx).numpy()
    for i in range(steps):
        r_logits, r_cache = step(params, r_cache, jnp.asarray(x[:, i:i + 1]))
        logits, cache = decode_step(model, cache, t, tx[:, i:i + 1])
        _close_logits(logits.numpy(), np.asarray(r_logits), t, f"step {i}")
        if full is not None:
            _close_logits(logits.numpy()[:, 0], full[:, i], t, f"forward {i}")
        assert cache["pos"] == int(r_cache["pos"]) == i + 1
        for li, (want, got) in enumerate(zip(
                convert.unstack_layers(r_cache["blocks"], r),
                cache["layers"])):
            assert set(got) == set(want)
            for name in want:
                assert got[name].dtype == torch.float32
                _close(got[name].numpy(), want[name], f"{i} {li} {name}")


def test_layer_functions_and_attention_match_reference():
    """rms_norm, RoPE, M-RoPE; ``attention_fwd`` with the reference's
    weights; the attention core against ``chunked_causal_attention``
    (windowed too); and at S = 2,100 the reference's chunking raises while
    the port's core equals the plain version."""
    rng = np.random.default_rng(3)
    f32 = dict(rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
        RL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), **f32)
    pos = rng.integers(0, 2048, (2, 37)).astype(np.int32)
    pos3 = rng.integers(0, 2048, (2, 37, 3)).astype(np.int32)
    for t_cs, r_cs in (
            (TL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6),
             RL.rope_cos_sin(jnp.asarray(pos), 16, 1e6)),
            (TL.mrope_cos_sin(torch.from_numpy(pos3), 16, 1e4, (4, 2, 1)),
             RL.mrope_cos_sin(jnp.asarray(pos3), 16, 1e4, (4, 2, 1)))):
        for a, b in zip(t_cs, r_cs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **f32)
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(x), *t_cs).numpy(),
            np.asarray(RL.apply_rope(jnp.asarray(x), *r_cs)), **f32)

    r, t = _configs("qwen3_8b", d_model=64, heads=4, kv=2)
    r_att = RL.init_attention(r, jax.random.PRNGKey(2))[0]
    att = TL.init_attention(t, None, "cpu")
    att.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in r_att.items()})
    h = rng.standard_normal((2, 300, 64)).astype(np.float32)
    p300 = np.broadcast_to(np.arange(300, dtype=np.int32), (2, 300))
    _close(att(torch.from_numpy(h), torch.from_numpy(p300.copy())).numpy(),
           np.asarray(RL.attention_fwd(r_att, jnp.asarray(h), r,
                                       jnp.asarray(p300))), "attention_fwd")

    for s, window in ((2048, 0), (300, 64), (2048, 1000)):
        q = rng.standard_normal((1, s, 4, 16)).astype(np.float32)
        k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
                for _ in range(2))
        got = TL.AttentionCore(window)(*map(torch.from_numpy, (q, k, v)))
        want = RL.chunked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                           window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    q, k, v = (torch.randn(1, 2100, 2, 8, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    with pytest.raises(TypeError):
        RL.chunked_causal_attention(*(jnp.asarray(a.numpy())
                                      for a in (q, k, v)))
    torch.testing.assert_close(TL.AttentionCore(0)(q, k, v),
                               TR.causal_attention(q, k, v, 0),
                               rtol=0, atol=0)
