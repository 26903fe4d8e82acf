"""Port parity, attention: the plain version of the port's flash kernel.

The port's ``flash_attention`` on CPU tensors runs its plain PyTorch
version (``kernels/ref.py``); it is held here against the JAX package's
Pallas kernel in interpret mode on the shapes of
``tests/test_flash_attention.py``, against ``ref.causal_attention`` and
the models' ``chunked_causal_attention``. Tolerances are the reference's
own: atol = rtol = 2e-5 in float32 (sums in another order), atol 3e-2 in
bfloat16. The CUDA kernel is held against this plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as RR
from repro.kernels.flash_attention import (flash_attention as r_flash,
                                           flash_attention_folded as r_folded)
from repro.models.layers import chunked_causal_attention
from repro_torch.kernels import flash_attention as TF, ref as TR

# the shapes of tests/test_flash_attention.py: b, s, h, kv, d, window and
# the TPU kernel's block_q, block_kv
SHAPES = [(2, 64, 4, 2, 16, 0, 16, 16), (1, 128, 8, 1, 32, 0, 32, 64),
          (2, 64, 4, 4, 16, 24, 16, 8), (1, 96, 6, 2, 8, 0, 48, 32),
          (1, 32, 2, 2, 64, 8, 32, 16)]
F32 = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, sq, h, kv, d, skv=None):
    rng = np.random.default_rng(seed)
    skv = sq if skv is None else skv
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, d)).astype(np.float32),
            rng.normal(size=(b, skv, kv, d)).astype(np.float32))


def _port(q, k, v, **kw):
    return TF.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              **kw).numpy()


@pytest.mark.parametrize("b,s,h,kv,d,window,bq,bkv", SHAPES)
def test_matches_reference_kernel_and_oracle(b, s, h, kv, d, window, bq,
                                             bkv):
    """Equal to the Pallas kernel (interpret mode) and to the oracle."""
    q, k, v = _inputs(s + d, b, s, h, kv, d)
    got = _port(q, k, v, window=window)
    assert got.dtype == np.float32 and got.shape == q.shape
    kern = r_flash(*(jnp.asarray(x) for x in (q, k, v)), window=window,
                   block_q=bq, block_kv=bkv, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    oracle = RR.causal_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **F32)


@pytest.mark.parametrize("d,window", [(120, 0), (120, 37), (256, 0),
                                      (256, 5)])
def test_wide_heads_match_oracle(d, window):
    """The models' head dims 120 and 256 (Pallas needs neither)."""
    q, k, v = _inputs(d, 1, 80, 4, 2, d)
    np.testing.assert_allclose(
        _port(q, k, v, window=window),
        np.asarray(RR.causal_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                       window=window)), **F32)


def test_matches_model_chunked_attention():
    q, k, v = _inputs(3, 2, 64, 4, 2, 16)
    want = chunked_causal_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                    chunk_q=32, chunk_kv=32)
    np.testing.assert_allclose(_port(q, k, v), np.asarray(want), atol=2e-5)
    want_w = chunked_causal_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      window=20, chunk_q=16, chunk_kv=16)
    np.testing.assert_allclose(_port(q, k, v, window=20), np.asarray(want_w),
                               atol=2e-5)


def test_bf16_matches_reference_kernel():
    rng = np.random.default_rng(0)
    arrs = [jnp.asarray(rng.normal(size=shape)).astype(jnp.bfloat16)
            for shape in ((1, 64, 4, 16), (1, 64, 2, 16), (1, 64, 2, 16))]
    want = r_flash(*arrs, block_q=32, block_kv=32, interpret=True)
    got = TF.flash_attention(*(torch.from_numpy(
        np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in arrs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_folded_layout_matches_reference_kernel():
    """flash_attention_folded on [BH, S, D] with groups, as the Pallas
    kernel's folded entry point."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(6, 64, 16)).astype(np.float32)
    k = rng.normal(size=(3, 64, 16)).astype(np.float32)
    v = rng.normal(size=(3, 64, 16)).astype(np.float32)
    want = r_folded(*(jnp.asarray(x) for x in (q, k, v)), groups=2,
                    window=9, block_q=16, block_kv=16, interpret=True)
    got = TF.flash_attention_folded(*(torch.from_numpy(x) for x in (q, k, v)),
                                    groups=2, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("s,bq,bkv,first_bad", [(96, 32, 64, 64),
                                                (100, 32, 32, 96)])
def test_reference_fault_ragged_kv_tail_dropped(s, bq, bkv, first_bad):
    """Reference fault 6: the TPU kernel visits skv // block_kv full kv
    blocks, so keys of a ragged last block are dropped from query
    ``first_bad`` on; the port attends every key and equals the oracle."""
    q, k, v = _inputs(s, 1, s, 2, 2, 16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    oracle = np.asarray(RR.causal_attention(jq, jk, jv))
    kern = np.asarray(r_flash(jq, jk, jv, block_q=bq, block_kv=bkv,
                              interpret=True))
    err = np.abs(kern - oracle).max(axis=(0, 2, 3))
    assert err[:first_bad].max() < 2e-5 and err[first_bad:].max() > 1e-2
    np.testing.assert_allclose(_port(q, k, v), oracle, **F32)


@pytest.mark.parametrize("sq,skv,window", [(50, 50, 0), (70, 30, 5),
                                           (30, 70, 0), (70, 30, 0),
                                           (64, 64, 200)])
def test_plain_version_chunks_and_keyless_rows(monkeypatch, sq, skv, window):
    """Chunked queries (each against only its band's keys) equal one
    chunk; rows that see no key (Sq > Skv + window) average every value,
    as a plain softmax over -1e30 scores does."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(sq, 2, sq, 4, 2, 8, skv))
    whole = TR.causal_attention(q, k, v, window)
    monkeypatch.setattr(TR, "_ATTN_CHUNK_CELLS", 100)
    np.testing.assert_allclose(TR.causal_attention(q, k, v, window).numpy(),
                               whole.numpy(), **F32)
    if window and sq > skv + window:
        mean = v.mean(dim=1).repeat_interleave(2, dim=1)
        np.testing.assert_allclose(whole[:, skv + window:].numpy(),
                                   mean[:, None].expand(
                                       -1, sq - skv - window, -1, -1).numpy(),
                                   **F32)


def test_wrappers_validate_inputs():
    """Types, shapes, head counts, head dims and windows are checked
    before any work, on the CPU path too."""
    q = torch.zeros((1, 8, 4, 16))
    bad = [((q, q.double(), q.double()), {}), ((q.half(),) * 3, {}),
           ((q, q[:, :, :3], q[:, :, :3]), {}),
           ((q, q[:, :, :2], q[:, :, :1]), {}),
           ((torch.zeros((1, 8, 4, 300)),) * 3, {}),
           ((q, q, q), {"window": -1}), ((q[0], q[0], q[0]), {})]
    for args, kw in bad:
        with pytest.raises(ValueError):
            TF.flash_attention(*args, **kw)
    with pytest.raises(ValueError, match="groups"):
        TF.flash_attention_folded(q[0], q[0], q[0], groups=3)
    before = dict(TF.LAUNCHES)
    TF.flash_attention(q, q[:, :, :2], q[:, :, :2])
    assert TF.LAUNCHES == before


def _emulate_tensor_core_kernel(q, k, v, window):
    """The arithmetic of ``csrc/flash_attention_wgmma.cu`` in plain torch
    (CPU, float32 with bf16 roundings where the kernel rounds): kv tiles of
    128 keys (64 at D > 128), scores scaled by log2(e)/sqrt(D) for exp2,
    -1e30 where masked, the online softmax, P rounded to bfloat16 before
    P·V, l summed from the fp32 P, the output rounded to bfloat16. Every
    query row visits every tile; a fully masked tile changes nothing for a
    row that sees a key, and a row that sees none averages every value,
    as in the kernel. Only this test uses it."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    bkv = 64 if d > 128 else 128
    qf = q.float().permute(0, 2, 1, 3)
    kf, vf = (x.float().repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
              for x in (k, v))
    m = torch.full((b, h, sq, 1), TR.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, bkv):
        kpos = torch.arange(k0, min(skv, k0 + bkv))[None, :]
        s = qf @ kf[:, :, k0:k0 + bkv].transpose(-1, -2) * (
            math.log2(math.e) / math.sqrt(d))
        seen = kpos <= qpos
        if window:
            seen &= kpos > qpos - window
        s = torch.where(seen, s, TR.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :,
                                                              k0:k0 + bkv]
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("d", [16, 64, 120, 128, 256])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)])
def test_bf16_tensor_core_arithmetic_within_restated_bound(d, h, kv):
    """The bfloat16 kernel's arithmetic (P rounded to bf16 before P·V)
    stays within the restated bf16 tolerance of the plain version: atol
    1e-3 + 2^-8·max|v| (twice the 2^-9·max|v| that a bf16 P can move an
    output), rtol 1e-2, and a mean error of at most 1e-3; over windows
    0/8/4096, a few-key prefix (the first rows see 1..8 keys), and Sq >
    Skv with rows that see no key."""
    for sq, skv, window in ((200, 200, 0), (200, 200, 8), (150, 150, 4096),
                            (150, 40, 8)):
        rng = np.random.default_rng(d * 31 + h * 7 + kv + sq + window)
        q, k, v = (torch.from_numpy(rng.normal(size=(1, s, n, d)).astype(
            np.float32)).to(torch.bfloat16)
            for s, n in ((sq, h), (skv, kv), (skv, kv)))
        got = _emulate_tensor_core_kernel(q, k, v, window).float()
        want = TR.causal_attention(q, k, v, window).float()
        atol = 1e-3 + 2.0 ** -8 * float(v.float().abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                   rtol=1e-2)
        assert float((got - want).abs().mean()) <= 1e-3


def test_tma_layout_preparation():
    """bfloat16 inputs that TMA can read (last dim contiguous and a
    multiple of 8, base and longer-than-1 strides multiples of 16 bytes)
    are used in place, heads sliced from a wider tensor included; others
    become a contiguous copy, zero-padded to a multiple of 8 in D."""
    wide = torch.randn((2, 33, 12, 64)).to(torch.bfloat16)
    for x in (wide, wide[:, :, 8:10], wide[:, :, 1:3], wide[:, :1, :1]):
        assert TF.tma_ready(x) and TF.tma_operand(x) is x
    odd = torch.randn((2, 33, 4, 100)).to(torch.bfloat16)
    padded = TF.tma_operand(odd)
    assert not TF.tma_ready(odd) and padded.shape == (2, 33, 4, 104)
    assert padded.is_contiguous() and TF.tma_ready(padded)
    assert torch.equal(padded[..., :100], odd)
    assert not padded[..., 100:].any()
    misfits = [
        torch.randn((2, 33, 4, 68)).to(torch.bfloat16)[..., :64],  # 136 B
        wide.flatten()[1:1 + 33 * 4 * 64].view(1, 33, 4, 64),  # base + 2 B
        wide[:, :, :1].expand(2, 33, 4, 64),                   # stride 0
        torch.randn((2, 33, 64, 16)).to(torch.bfloat16).transpose(2, 3),
    ]
    for x in misfits:
        got = TF.tma_operand(x)
        assert not TF.tma_ready(x) and TF.tma_ready(got)
        assert got.is_contiguous() and torch.equal(got, x)
