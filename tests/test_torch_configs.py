"""Port parity, configs: the architecture registry, the model and shape
configs and the flop arithmetic.

``repro_torch.configs`` and ``repro_torch.models.config`` are the port's
own copies of pure-Python modules; they must equal the JAX package's
field by field, and ``repro_torch.analysis.roofline``'s flop counts must
equal the reference's exactly (the same float arithmetic). Only the peak
rates differ: the port's are the H100's.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses

import pytest

from repro import configs as RC
from repro.analysis import roofline as RR
from repro.models import config as RM
from repro_torch import configs as TC
from repro_torch.analysis import roofline as TR
from repro_torch.models import config as TM

#: the reference's shape cells, plus the prefill cell the chip run drives
#: and two small ones (a window wider than the sequence, one token)
EXTRA_SHAPES = [("prefill_8k", 8192, 1, "prefill"),
                ("prefill_2k", 2048, 2, "prefill"),
                ("decode_1", 1, 4, "decode"), ("train_64", 64, 8, "train")]


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_and_every_config_equal_the_reference():
    """Ids, aliases, long-context set, and each of the ten configs, by id
    and by alias: the same fields with the same values and defaults."""
    assert TC.registry() == RC.registry()
    assert TC._ALIASES == RC._ALIASES
    assert TC.LONG_CONTEXT_ARCHS == RC.LONG_CONTEXT_ARCHS
    assert ([(f.name, f.default) for f in dataclasses.fields(TM.ModelConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(RM.ModelConfig)])
    assert len(TC.all_configs()) == 10
    for arch, cfg in TC.all_configs().items():
        assert isinstance(cfg, TM.ModelConfig)
        assert _as_dict(cfg) == _as_dict(RC.get(arch)), arch
    for alias, arch in TC._ALIASES.items():
        assert _as_dict(TC.get(alias)) == _as_dict(RC.get(alias))
        assert TC.get(alias).name == arch


def test_param_counts_and_derived_fields_equal_the_reference():
    """total/active params, padded vocab, period and the SSM widths of the
    ten full configs and of their reduced forms."""
    for arch in TC.registry():
        for t, r in ((TC.get(arch), RC.get(arch)),
                     (TM.reduced(TC.get(arch)), RM.reduced(RC.get(arch)))):
            assert t.total_params() == r.total_params(), arch
            assert t.active_params() == r.active_params(), arch
            for name in ("padded_vocab", "period", "ssm_d_inner",
                         "ssm_heads", "attention_free"):
                assert getattr(t, name) == getattr(r, name), (arch, name)
    assert 8.1e9 < TC.get("qwen3_8b").total_params() < 8.3e9


@pytest.mark.parametrize("kw", [{}, dict(layers=4, d_model=128, heads=4,
                                         ff=512, vocab=512),
                                dict(layers=3, d_model=96, heads=6, kv=3),
                                dict(layers=8, d_model=256, heads=8, kv=1,
                                     ff=64, vocab=1000)])
def test_shapes_and_reduced_equal_the_reference(kw):
    """SHAPES, shapes_for (ids and aliases) and ``reduced`` under the
    server's and other arguments."""
    assert {k: _as_dict(v) for k, v in TM.SHAPES.items()} == \
        {k: _as_dict(v) for k, v in RM.SHAPES.items()}
    for name in list(TC.registry()) + list(TC._ALIASES):
        assert TC.shapes_for(name) == RC.shapes_for(name)
    for arch in TC.registry():
        assert _as_dict(TM.reduced(TC.get(arch), **kw)) == \
            _as_dict(RM.reduced(RC.get(arch), **kw)), arch


def test_flops_equal_the_reference_for_every_config_and_shape():
    """model_flops and attention_flops for every (config, shape) pair,
    full and reduced; the peaks are the H100's, not the TPU's."""
    shapes = [(TM.SHAPES[k], RM.SHAPES[k]) for k in TM.SHAPES]
    shapes += [(TM.ShapeConfig(*s), RM.ShapeConfig(*s)) for s in EXTRA_SHAPES]
    for arch in TC.registry():
        for t, r in ((TC.get(arch), RC.get(arch)),
                     (TM.reduced(TC.get(arch)), RM.reduced(RC.get(arch)))):
            for ts, rs in shapes:
                assert TR.model_flops(t, ts) == RR.model_flops(r, rs)
                assert TR.attention_flops(t, ts) == RR.attention_flops(r, rs)
    assert (TR.PEAK_FLOPS_BF16, TR.HBM_BW) == (989e12, 3.35e12)
    prefill = TM.ShapeConfig("prefill_8k", 8192, 1, "prefill")
    q = TC.get("qwen3_8b")
    bound_s = (TR.model_flops(q, prefill) + TR.attention_flops(q, prefill)) \
        / TR.PEAK_FLOPS_BF16
    assert 0.15 < bound_s < 0.16
