"""Port parity, serving: ``repro_torch.launch.serve`` against
``repro.launch.serve``.

The port's server holds the reference server's weights (carried by
``convert.model_params_from_numpy``); greedy generation must then return
the reference's tokens exactly: both argmax over float32 logits that
agree within 1e-4 of their magnitude (``tests/test_torch_models.py``), and
no step of these runs has two logits that close at the top. Sampling
draws from a ``torch.Generator`` (the reference's distribution, another
stream than ``jax.random.categorical``), so sampled tokens are checked to
repeat under one seed, to change with it and to lie in the vocab.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro_torch import convert
from repro_torch.launch import serve as TS

PROMPTS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]]


@pytest.mark.parametrize("arch,tokens", [("gemma_2b", 16),
                                         ("h2o_danube3_4b", 72),
                                         ("phi35_moe", 16),
                                         ("deepseek_v3", 16),
                                         ("mamba2_130m", 16),
                                         ("jamba15_large", 16)])
def test_greedy_tokens_equal_the_reference(arch, tokens):
    """The reference server's weights in the port's server give the same
    greedy tokens; the window config decodes past its 64-slot ring; the
    MoE, MLA, SSM and hybrid configs route, cache and decode as the
    reference does."""
    sc = RS.ServeConfig(arch=arch)
    ref = RS.BatchedServer(sc)
    want = ref.generate(PROMPTS, tokens, greedy=True)
    port = TS.BatchedServer(TS.ServeConfig(arch=arch), device="cpu")
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    port.params = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), port.cfg, device="cpu")
    got = port.generate(PROMPTS, tokens, greedy=True)
    assert got.dtype == np.int32 and got.shape == (4, tokens)
    np.testing.assert_array_equal(got, want)


def test_sampled_tokens_repeat_under_one_seed():
    """Sampling at the server's temperature: one seed gives one stream,
    another seed another; every token lies in [0, vocab)."""
    a = TS.BatchedServer(TS.ServeConfig(), device="cpu")
    first = a.generate(PROMPTS, 24)
    np.testing.assert_array_equal(a.generate(PROMPTS, 24), first)
    again = TS.BatchedServer(TS.ServeConfig(), device="cpu")
    np.testing.assert_array_equal(again.generate(PROMPTS, 24), first)
    other = TS.BatchedServer(TS.ServeConfig(seed=5), device="cpu")
    assert not np.array_equal(other.generate(PROMPTS, 24), first)
    assert first.min() >= 0 and first.max() < a.cfg.vocab_size
    gen = torch.Generator().manual_seed(1)
    hot = TS.generate(a.params, a.cfg, PROMPTS[:2], 8, max_len=16,
                      temperature=1e3, generator=gen)
    assert hot.shape == (2, 8) and 0 <= hot.min() and \
        hot.max() < a.cfg.vocab_size


def test_generate_rejects_what_does_not_fit():
    """More prompts than the batch, or more positions than the cache of a
    config without a window, raise before decoding."""
    server = TS.BatchedServer(TS.ServeConfig(batch=2, max_len=8),
                              device="cpu")
    with pytest.raises(ValueError, match="batch"):
        server.generate(PROMPTS, 2)
    with pytest.raises(ValueError, match="max_len"):
        server.generate(PROMPTS[:2], 6)


def test_main_runs_on_the_cpu(capsys):
    """The launcher with ``--device cpu``: the reference's defaults
    (gemma_2b reduced, 4 prompts, 32 tokens) and its output line."""
    out = TS.main(["--device", "cpu"])
    assert out.shape == (4, 32)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated (4, 32) in ")
    assert lines[0].endswith("on cpu")
