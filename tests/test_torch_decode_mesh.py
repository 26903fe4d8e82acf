"""Port parity, decoding over a mesh: decode steps on 4 gloo ranks with
the cache split over positions against the JAX package's
``decode_step`` jitted on a (2, 2) mesh of 4 host devices.

Both sides lay the parameters out by ``train_state_shardings``, the cache
by ``cache_shardings`` (its positions over "model", its batch over
"data": ``decode_cache_seq`` takes "model" first, so the kv heads stay
whole) and each step's tokens by ``batch_shardings``. The reference runs
in a subprocess that sets ``XLA_FLAGS`` first, on a hand-built ``Mesh``
of Auto axes (ROADMAP reference fault 11); its ``init_params`` weights are
carried into the port's ranks (``distributed.report.decode_report``).
Each case decodes as many tokens as the cache holds positions, so every
rank writes its half of the positions and the softmax terms of both
halves are merged in every step after the first half.

Tolerance (float32, reduced configs): every step's logits within 1e-5 ·
max |reference logits| (the port's softmax is merged over the position
shards in another order).
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np

from repro_torch import configs as TC
from repro_torch.distributed import spawn
from repro_torch.distributed.report import decode_report
from repro_torch.models import reduced

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs as RC
from repro.distributed import sharding as SH
from repro.distributed import step as STEP
from repro.models import ShapeConfig, init_cache, init_params, reduced
from repro.optim import AdamW
with open(sys.argv[2], "rb") as f:
    cases = pickle.load(f)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = []
for c in cases:
    cfg = dataclasses.replace(reduced(RC.get(c["arch"])), **c["fields"])
    tokens, max_len = c["tokens"], c["max_len"]
    b = tokens.shape[0]
    params = init_params(cfg, jax.random.PRNGKey(0))
    cache = init_cache(cfg, b, max_len)
    with SH.use_rules(mesh):
        p_sh = STEP.train_state_shardings(cfg, AdamW(), mesh)["params"]
        c_sh = STEP.cache_shardings(cfg, b, max_len, mesh)
        in_sh = STEP.batch_shardings(
            cfg, ShapeConfig("d", max_len, b, "decode"), mesh)["inputs"]
        step = jax.jit(STEP.make_decode_step(cfg),
                       in_shardings=(p_sh, c_sh, in_sh),
                       out_shardings=(STEP.logits_sharding(cfg, mesh, b, 1),
                                      c_sh))
        logits = []
        for t in range(tokens.shape[1]):
            x, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]))
            logits.append(np.asarray(x)[:, 0])
    out.append({"params": jax.tree.map(np.asarray, params),
                "logits": np.stack(logits)})
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""

#: (arch, config fields, cache positions): grouped-query attention, MLA
#: (with its MoE layer), and a sliding window of 4 positions whose ring
#: buffer the 8 steps wrap
CASES = (("qwen3_8b", {}, 8), ("deepseek_v3", {}, 8),
         ("h2o_danube3_4b", {"sliding_window": 4}, 8))


def test_decode_over_position_split_cache_matches_reference(tmp_path):
    """Every step's logits of the three cases; the cache is split over
    positions on every rank."""
    rng = np.random.default_rng(11)
    cases = []
    for arch, fields, max_len in CASES:
        fields = {"dtype": "float32", **fields}
        vocab = reduced(TC.get(arch)).vocab_size
        cases.append({"arch": arch, "fields": fields, "max_len": max_len,
                      "tokens": rng.integers(0, vocab, (2, 8)).astype(
                          np.int32)})
    with open(tmp_path / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, src, str(tmp_path / "cases.pkl"),
         str(tmp_path / "out.pkl")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        refs = pickle.load(f)
    port_cases = [{
        "mesh": ((2, 2), ("data", "model")),
        "cfg": dataclasses.replace(reduced(TC.get(c["arch"])),
                                   **c["fields"]),
        "params": r["params"], "tokens": c["tokens"],
        "max_len": c["max_len"]} for c, r in zip(cases, refs)]
    ranks = spawn(decode_report, 4, args=(port_cases, "cpu"), device="cpu",
                  timeout_s=120)
    for i, (c, ref) in enumerate(zip(cases, refs)):
        want = ref["logits"]
        length = min(c["max_len"], c["fields"].get("sliding_window")
                     or c["max_len"])
        for rank in ranks:
            got = rank[i]
            assert got["placements"] == ("S(0)", "S(1)"), (c["arch"], got)
            assert got["local"] == length // 2
            err = float(np.abs(got["logits"] - want).max())
            assert got["logits"].shape == want.shape
            assert err <= 1e-5 * float(np.abs(want).max()), (c["arch"], err)
