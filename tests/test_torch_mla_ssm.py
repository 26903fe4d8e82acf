"""Port parity, MLA and SSM layers: ``mla_fwd`` and the absorbed
``mla_decode``, ``ssm_fwd`` and ``ssm_decode`` with their caches, against
the JAX package; MLA's narrow v through the attention core; a bf16 SSM
layer's decode against its prefill; reference fault 9.

Reduced float32 configs; inputs from numpy under a seed; each reference
layer's ``init_*`` weights loaded into the port's module. Tolerance: max
|port - reference| <= 1e-4 · max(max |reference|, 1) for outputs and
caches (float32 sums in another order), as the model tests.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as RC
from repro.models import layers as RL
from repro.models import reduced as r_reduced
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import ref as TR
from repro_torch.models import forward, init_params
from repro_torch.models import layers as TL
from repro_torch.models import reduced
from repro_torch.models import ssm as TS


def _configs(arch):
    r = dataclasses.replace(r_reduced(RC.get(arch)), dtype="float32")
    t = dataclasses.replace(reduced(TC.get(arch)), dtype="float32")
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    return r, t


def _load(module, ref_params):
    flat = {}
    convert._dotted(jax.tree.map(np.asarray, ref_params), "", flat)
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in flat.items()})
    return module


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(float(np.abs(want).max()), 1.0), (what, err)


def _x(cfg, b, s, seed):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            .astype(np.float32))


def test_mla_fwd_and_decode_steps_match_reference():
    """``mla_fwd`` (qk head dim 16 + 8, v head dim 16, k_rope broadcast over
    the heads) and 20 absorbed ``mla_decode`` steps, with the compressed
    cache after each; the port's decode also equals its own forward."""
    r, t = _configs("deepseek_v3")
    rp = RL.init_mla(r, jax.random.PRNGKey(1))[0]
    mla = _load(TL.init_mla(t, None, "cpu"), rp)
    b, s, max_len = 2, 20, 24
    x = _x(t, b, s, 2)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    fwd = TL.mla_fwd(mla, torch.from_numpy(x), t, torch.from_numpy(pos))
    _close(fwd.numpy(), RL.mla_fwd(rp, jnp.asarray(x), r, jnp.asarray(pos)),
           "mla_fwd")

    step = jax.jit(lambda c, xi, p: RL.mla_decode(rp, xi, c, r, p))
    r_cache = RL.init_mla_cache(r, b, max_len, jnp.float32)[0]
    cache = TL.init_mla_cache(t, b, max_len, torch.float32, "cpu")
    for i in range(s):
        want, r_cache = step(r_cache, jnp.asarray(x[:, i:i + 1]),
                             jnp.int32(i))
        got = TL.mla_decode(mla, torch.from_numpy(x[:, i:i + 1]), cache, t, i)
        _close(got.numpy(), want, f"step {i}")
        _close(got.numpy()[:, 0], fwd.numpy()[:, i], f"forward {i}")
        for name in ("ckv", "krope"):
            _close(cache[name].numpy(), r_cache[name], f"{i} {name}")


@pytest.mark.parametrize("arch", ["mamba2_130m", "jamba15_large"])
def test_ssm_fwd_and_decode_steps_match_reference(arch):
    """``ssm_fwd`` over 4 chunks of 8 (the float32 state carried across)
    and over one chunk shorter than ``ssm_chunk``; 32 ``ssm_decode`` steps
    with the convolution windows and the state after each; the port's
    decode also equals its own forward."""
    r, t = _configs(arch)
    rp = RS.init_ssm(r, jax.random.PRNGKey(3))[0]
    ssm = _load(TS.init_ssm(t, None, "cpu"), rp)
    b, s = 2, 32
    x = _x(t, b, s, 4)
    fwd = TS.ssm_fwd(ssm, torch.from_numpy(x), t)
    _close(fwd.numpy(), RS.ssm_fwd(rp, jnp.asarray(x), r), "ssm_fwd")
    _close(TS.ssm_fwd(ssm, torch.from_numpy(x[:, :5]), t).numpy(),
           RS.ssm_fwd(rp, jnp.asarray(x[:, :5]), r), "ssm_fwd S=5")

    step = jax.jit(lambda c, xi: RS.ssm_decode(rp, xi, c, r, jnp.int32(0)))
    r_cache = RS.init_ssm_cache(r, b, jnp.float32)[0]
    cache = TS.init_ssm_cache(t, b, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in r_cache.items()}
    for i in range(s):
        want, r_cache = step(r_cache, jnp.asarray(x[:, i:i + 1]))
        got = TS.ssm_decode(ssm, torch.from_numpy(x[:, i:i + 1]), cache, t)
        _close(got.numpy(), want, f"step {i}")
        _close(got.numpy()[:, 0], fwd.numpy()[:, i], f"forward {i}")
        for name in ("conv_x", "conv_bc", "state"):
            _close(cache[name].numpy(), r_cache[name], f"{i} {name}")


def test_bf16_ssm_decode_stays_near_its_prefill():
    """One full-width bf16 ``mamba2_130m`` SSM layer (the reference's
    draw): 64 ``ssm_decode`` steps at batch 2 against ``ssm_fwd`` on the
    same unit-normal input, max |diff| within 2^-5 of max |forward| and
    mean within 2^-7 of mean |forward|, ``chip_smoke.py`` phase 3j's
    per-layer bounds; the reference's own decode and forward meet them
    too (``tests/bf16_drift.py`` reads both over more draws)."""
    r = dataclasses.replace(RC.get("mamba2_130m"), dtype="bfloat16")
    t = dataclasses.replace(TC.get("mamba2_130m"), dtype="bfloat16")
    rp = RS.init_ssm(r, jax.random.PRNGKey(0))[0]
    flat = {}
    convert._dotted(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), rp), "", flat)
    ssm = TS.init_ssm(t, None, "cpu")
    ssm.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        getattr(ssm, k).dtype) for k, v in flat.items()})
    x = np.random.default_rng(10).standard_normal((2, 64, t.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()

    step = jax.jit(lambda c, xi: RS.ssm_decode(rp, xi, c, r, jnp.int32(0)))
    r_cache = RS.init_ssm_cache(r, 2, jnp.bfloat16)[0]
    r_dec = []
    for i in range(64):
        out, r_cache = step(r_cache, xj[:, i:i + 1])
        r_dec.append(np.asarray(out.astype(jnp.float32)))
    r_fwd = np.asarray(RS.ssm_fwd(rp, xj, r).astype(jnp.float32))
    with torch.inference_mode():
        fwd = TS.ssm_fwd(ssm, xt, t).float().numpy()
        cache = TS.init_ssm_cache(t, 2, torch.bfloat16, "cpu")
        dec = np.concatenate([TS.ssm_decode(ssm, xt[:, i:i + 1], cache, t)
                              .float().numpy() for i in range(64)], 1)
    for what, d, f in (("port", dec, fwd),
                       ("reference", np.concatenate(r_dec, 1), r_fwd)):
        diff = np.abs(d - f)
        assert diff.max() <= 2.0 ** -5 * np.abs(f).max(), (what, diff.max())
        assert diff.mean() <= 2.0 ** -7 * np.abs(f).mean(), (what,
                                                             diff.mean())


def test_reference_fault_9_ragged_chunks():
    """S longer than ``ssm_chunk`` and not a multiple of it: the reference's
    ``ssm_fwd`` raises ``TypeError`` (its chunk reshape); the port's raises
    ``ValueError`` naming the precondition, through the layer and through
    a model's ``forward``. S = 64 runs on both."""
    r, t = _configs("mamba2_130m")
    rp = RS.init_ssm(r, jax.random.PRNGKey(5))[0]
    ssm = _load(TS.init_ssm(t, None, "cpu"), rp)
    x = _x(t, 2, 60, 6)
    with pytest.raises(TypeError, match="reshape"):
        RS.ssm_fwd(rp, jnp.asarray(x), r)
    with pytest.raises(ValueError, match="multiple of it: S = 60, "
                                         "ssm_chunk = 8"):
        TS.ssm_fwd(ssm, torch.from_numpy(x), t)
    model = init_params(t, 0, device="cpu")
    with pytest.raises(ValueError, match="ssm_chunk"):
        forward(model, t, torch.zeros((1, 60), dtype=torch.long))
    assert forward(model, t, torch.zeros((1, 64), dtype=torch.long)
                   ).shape == (1, 64, t.padded_vocab)


def test_attention_core_takes_a_narrow_v():
    """The core pads a v narrower than q and k with zeros for the kernel
    and cuts the output back: equal to the reference's
    ``chunked_causal_attention`` on the narrow v (which scales by 1/sqrt
    of q's head dim too), and bit for bit to the plain version on the
    padded v, cut."""
    rng = np.random.default_rng(7)
    q, k = (rng.standard_normal((2, 96, 4, 24)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, 96, 4, 16)).astype(np.float32)
    got = TL.AttentionCore(0)(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 96, 4, 16)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(RL.chunked_causal_attention(
            *map(jnp.asarray, (q, k, v)))), rtol=2e-5, atol=2e-5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        got, TR.causal_attention(tq, tk, F.pad(tv, (0, 8)))[..., :16],
        rtol=0, atol=0)
