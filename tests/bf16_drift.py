"""CPU readings of the bf16 drift that the port's bf16 bounds for SSD
(Mamba2) and MoE models rest on, the JAX package beside the port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/bf16_drift.py [--draws 5]

Each reading is max |a - b| over max |b| (logits or a layer's output):

1. ``mamba2_130m`` at full width in bf16, weights from the reference's
   ``init_params`` (one draw per seed) carried into the port: 64
   teacher-forced decode steps at batch 2 against the prefill of the same
   tokens, in the reference and in the port (``chip_smoke.py`` phase 3j's
   model-level check), and the port's prefill against the reference's.
2. One full-width ``mamba2_130m`` SSM layer on a unit-normal bf16 input:
   64 ``ssm_decode`` steps against ``ssm_fwd``, reference and port (phase
   3j's per-layer check); max, and mean |a - b| over mean |b|.
3. The card-vs-CPU model test's reduced configs (``test_torch_kernels_cuda``:
   3 layers, d_model 256): the port's bf16 logits against its float32
   logits on the same weights, prefill and 80 decode steps, with the MoE
   layers cut as that test cuts them and, for MoE configs, kept; the port
   against the reference, both in bf16.
4. One bf16 sublayer against float32 on the same weights and a unit-normal
   input, d_model 256 and 768: an SSD layer, an attention and an MLP
   sublayer; the SSD layer also with one bf16 rounding at a time put into
   an otherwise float32 run (which rounding carries the error).
"""
import argparse
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro import configs as RC
from repro.models import decode_step as r_decode_step
from repro.models import forward as r_forward
from repro.models import init_cache as r_init_cache
from repro.models import init_params as r_init_params
from repro.models import reduced as r_reduced
from repro.models import ssm as RS
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.models import layers as TL
from repro_torch.models import reduced
from repro_torch.models import ssm as TS

#: the card test's reduced size
CARD_KW = dict(layers=3, d_model=256, heads=4, kv=2, ff=512, vocab=1000)
#: the stages of an SSD layer that round to the model's dtype in bf16
STAGES = ("proj", "conv", "silu", "wmat", "y", "gate", "norm", "out")


def f32(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def mean_rel(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def pair(arch, kw, dtype, seed, cut=False):
    """The reference's config and params, the port's config and model of
    them; ``cut`` moves ``moe_layer_start`` past the last layer."""
    r, t = RC.get(arch), TC.get(arch)
    if kw is not None:
        r, t = r_reduced(r, **kw), reduced(t, **kw)
    r, t = (dataclasses.replace(c, dtype=dtype) for c in (r, t))
    if cut:
        r, t = (dataclasses.replace(c, moe_layer_start=c.num_layers)
                for c in (r, t))
    params = r_init_params(r, jax.random.PRNGKey(seed))
    model = convert.model_params_from_numpy(jax.tree.map(f32, params), t,
                                            device="cpu")
    return r, t, params, model


def ref_run(params, r, toks, steps):
    """The reference's prefill logits and ``steps`` decode steps."""
    step = jax.jit(lambda c, x: r_decode_step(params, c, r, x))
    cache = r_init_cache(r, toks.shape[0], max(steps, 96))
    out = []
    for i in range(steps):
        lg, cache = step(cache, jnp.asarray(toks[:, i:i + 1]))
        out.append(f32(lg)[:, 0])
    return f32(r_forward(params, r, jnp.asarray(toks))), np.stack(out, 1)


def port_run(model, t, toks, steps):
    with torch.inference_mode():
        tt = torch.from_numpy(toks).long()
        cache = init_cache(t, toks.shape[0], max(steps, 96), device="cpu")
        out = []
        for i in range(steps):
            lg, cache = decode_step(model, cache, t, tt[:, i:i + 1])
            out.append(lg[:, 0].float().numpy())
        return forward(model, t, tt).float().numpy(), np.stack(out, 1)


def model_drift(draws):
    print("1. mamba2_130m, full width, bf16: decode x64 vs prefill (batch 2)")
    for seed in range(draws):
        r, t, params, model = pair("mamba2_130m", None, "bfloat16", seed)
        v = t.vocab_size
        toks = np.random.default_rng(1).integers(0, v, (2, 64)).astype(
            np.int32)
        rf, rd = (a[..., :v] for a in ref_run(params, r, toks, 64))
        pf, pd = (a[..., :v] for a in port_run(model, t, toks, 64))
        print(f"  draw {seed}: reference {rel(rd, rf):.4f}, port "
              f"{rel(pd, pf):.4f}; port vs reference prefill "
              f"{rel(pf, rf):.4f} (2L·2^-8 = {2 * t.num_layers / 256:.4f})",
              flush=True)


def layer_drift(draws):
    print("2. one mamba2_130m SSM layer, full width, bf16: ssm_decode x64 vs "
          "ssm_fwd (batch 2)")
    r = dataclasses.replace(RC.get("mamba2_130m"), dtype="bfloat16")
    t = dataclasses.replace(TC.get("mamba2_130m"), dtype="bfloat16")
    for seed in range(draws):
        rp = RS.init_ssm(r, jax.random.PRNGKey(seed))[0]
        flat = {}
        convert._dotted(jax.tree.map(f32, rp), "", flat)
        layer = TS.init_ssm(t, None, "cpu")
        layer.load_state_dict({k: torch.from_numpy(np.array(a)).to(
            getattr(layer, k).dtype) for k, a in flat.items()})
        x = np.random.default_rng(seed + 10).standard_normal(
            (2, 64, t.d_model)).astype(np.float32)
        xj, xt = jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).bfloat16()
        step = jax.jit(lambda c, xi: RS.ssm_decode(rp, xi, c, r, 0))
        cache = RS.init_ssm_cache(r, 2, jnp.bfloat16)[0]
        rd = []
        for i in range(64):
            o, cache = step(cache, xj[:, i:i + 1])
            rd.append(f32(o))
        rd, rf = np.concatenate(rd, 1), f32(RS.ssm_fwd(rp, xj, r))
        with torch.inference_mode():
            pf = TS.ssm_fwd(layer, xt, t).float().numpy()
            pc = TS.init_ssm_cache(t, 2, torch.bfloat16, "cpu")
            pd = np.concatenate([TS.ssm_decode(layer, xt[:, i:i + 1], pc, t)
                                 .float().numpy() for i in range(64)], 1)
        print(f"  draw {seed}: reference max {rel(rd, rf):.5f} mean "
              f"{mean_rel(rd, rf):.5f}; port max {rel(pd, pf):.5f} mean "
              f"{mean_rel(pd, pf):.5f}", flush=True)


def card_configs():
    print("3. the card test's reduced configs: port bf16 vs port float32 "
          "(same weights), prefill / decode x80; port vs reference, bf16")
    for arch in ("qwen3_8b", "h2o_danube3_4b", "phi35_moe", "deepseek_v3",
                 "mamba2_130m", "jamba15_large"):
        for cut in (True, False):
            if not cut and not TC.get(arch).moe_num_experts:
                continue
            r, t, params, m16 = pair(arch, CARD_KW, "bfloat16", 0, cut)
            t32 = dataclasses.replace(t, dtype="float32")
            m32 = convert.model_params_from_numpy(jax.tree.map(f32, params),
                                                  t32, device="cpu")
            v = t.vocab_size
            toks = np.random.default_rng(3).integers(
                0, v, (2, 304 if t.ssm else 300)).astype(np.int32)
            p16 = [a[..., :v] for a in port_run(m16, t, toks, 80)]
            p32 = [a[..., :v] for a in port_run(m32, t32, toks, 80)]
            ref = [a[..., :v] for a in ref_run(params, r, toks, 80)]
            print(f"  {arch}, MoE {'cut' if cut else 'kept'} ({t.num_layers} "
                  f"layers, 2L·2^-8 = {2 * t.num_layers / 256:.4f}): bf16 vs "
                  f"float32 {rel(p16[0], p32[0]):.4f} / "
                  f"{rel(p16[1], p32[1]):.4f}; port vs reference "
                  f"{rel(p16[0], ref[0]):.4f} / {rel(p16[1], ref[1]):.4f}",
                  flush=True)


def ssm_rounded(p, x, cfg, rnd):
    """``ssm_fwd`` in float32 with a bf16 rounding at each stage in
    ``rnd`` (``STAGES``): the projections, the convolution's sum, its
    SiLU, wmat, the scan's output y, the gate, the norm, ``out_proj``."""
    def r(a, stage):
        return a.bfloat16().float() if stage in rnd else a

    bsz, s, _ = x.shape
    n, h, hp = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    nc = s // q
    z, xc, bc, dt_raw = (r(a, "proj") for a in TS._project(p, x))

    def conv(a, w, b):
        pad = F.pad(a, (0, 0, w.shape[0] - 1, 0))
        out = r(sum(pad[:, i:i + s] * w[i] for i in range(w.shape[0])),
                "conv")
        return r(F.silu(r(out + b, "conv")), "silu")

    xs = conv(xc, p.conv_wx, p.conv_bx).reshape(bsz, nc, q, h, hp)
    bc = conv(bc, p.conv_wbc, p.conv_bbc)
    b_c, c_c = (a.reshape(bsz, nc, q, n) for a in (bc[..., :n], bc[..., n:]))
    dt = F.softplus(dt_raw + p.dt_bias).reshape(bsz, nc, q, h)
    cs = torch.cumsum(dt * -torch.exp(p.a_log), 2)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    li = torch.exp(cs[:, :, :, None] - cs[:, :, None]).masked_fill(
        ~tri[:, :, None], 0.0)
    wmat = r((c_c @ b_c.transpose(-1, -2))[..., None] * li
             * dt[:, :, None], "wmat")
    y = torch.einsum("bcijh,bcjhp->bcihp", wmat, xs)
    carry = torch.einsum("bcjn,bcjhp->bchpn", b_c, xs * (
        torch.exp(cs[:, :, -1:] - cs) * dt)[..., None])
    state = torch.zeros_like(carry[:, 0])
    for c in range(nc):
        state, carry[:, c] = (carry[:, c] + state
                              * torch.exp(cs[:, c, -1])[..., None, None],
                              state)
    y = y + torch.einsum("bcin,bchpn->bcihp", c_c, carry) \
        * torch.exp(cs)[..., None] + p.d_skip[:, None] * xs
    y = r(y.reshape(bsz, s, -1), "y")
    g = r(r(F.silu(z), "gate") * y, "gate")
    return r(r(TL.rms_norm(g, p.norm, cfg.norm_eps), "norm") @ p.out_proj,
             "out")


def sublayers():
    print("4. one bf16 sublayer vs float32, same weights and input (B 2, "
          "S 128)")
    for d in (256, 768):
        cfg = dataclasses.replace(TC.get("mamba2_130m"), num_layers=1,
                                  dtype="bfloat16")
        if d != cfg.d_model:
            cfg = dataclasses.replace(reduced(cfg, layers=1, d_model=d),
                                      dtype="bfloat16")
        dense = dataclasses.replace(reduced(
            TC.get("qwen3_8b"), layers=1, d_model=d, heads=4, kv=2,
            ff=4 * d), dtype="bfloat16")
        x = torch.randn((2, 128, d), generator=torch.Generator().manual_seed(1))
        x16 = x.bfloat16()
        x32 = x16.float()
        with torch.inference_mode():
            ssm = init_params(cfg, 0, device="cpu").layers[0].mixer
            exact = ssm_rounded(copy.deepcopy(ssm).float(), x32, cfg, ())
            row = {k: rel(ssm_rounded(copy.deepcopy(ssm).float(), x32, cfg,
                                      (k,)), exact) for k in STAGES}
            ssd = rel(TS.ssm_fwd(ssm, x16, cfg).float(), exact)
            layer = init_params(dense, 0, device="cpu").layers[0]
            pos = torch.arange(128)[None].expand(2, 128)
            attn = rel(layer.mixer(x16, pos).float(),
                       copy.deepcopy(layer.mixer).float()(x32, pos))
            mlp = rel(layer.ffn(x16).float(),
                      copy.deepcopy(layer.ffn).float()(x32))
        print(f"  d_model {d}: SSD layer {ssd:.4f}, attention {attn:.4f}, "
              f"MLP {mlp:.4f} (2^-8 = {2 ** -8:.4f}); the SSD layer with "
              f"one rounding: " + ", ".join(f"{k} {e:.4f}"
                                            for k, e in row.items()),
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=5,
                    help="weight draws for readings 1 and 2")
    args = ap.parse_args()
    torch.set_num_threads(4)
    model_drift(args.draws)
    layer_drift(min(args.draws, 3))
    card_configs()
    sublayers()


if __name__ == "__main__":
    main()
