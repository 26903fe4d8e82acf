"""The harness finds every part of a cell by name, and a new
configuration, traffic mix, job kind or per-layer metric is added as new
files only."""
import json
import textwrap

import pytest

from smallbench import ROOT, small_registry
from graphbench import harness
from graphbench.registry import HERE, Registry


def test_every_shipped_part_is_found_by_name():
    reg = Registry.load()
    names = {c["name"] for c in reg.bench["configs"]}
    for cell in reg.bench["workloads"]:
        assert cell["config"] in names
        assert reg.config(cell["config"])["name"] == cell["config"]
        job = reg.job(reg.mix(cell["traffic"])["job"])
        for fn in ("run", "counters", "keep", "reference", "compare"):
            assert callable(getattr(job, fn))
    for entry in reg.bench["configs"]:
        assert (ROOT / entry["file"]).is_file()
        assert json.loads((ROOT / entry["file"]).read_text())[
            "source"] == entry["source"]


def _quantity(name):
    return name.split(".")[0]


def test_metric_files_agree_with_the_benchmark():
    """Each per-layer metric's file states its unit, layer and the
    quantity it moves; a split ``<quantity>.<part>`` reads with the
    quantity's file, and every file is read by some metric."""
    reg = Registry.load()
    used = set()
    for entry in reg.bench["per_layer"]:
        mod = reg.metric(entry["name"])
        used.add(_quantity(entry["name"]))
        assert (mod.UNIT, mod.LAYER, _quantity(mod.MOVES)) == (
            entry["unit"], entry["layer"], _quantity(entry["moves"])), \
            entry["name"]
    assert sorted(p.stem for p in (HERE / "metrics").glob("*.py")) == sorted(
        used)


def test_moved_metric_is_reported_where_its_mover_is():
    """A per-layer metric moves an end-to-end metric that every cell it
    lists reports, and the harness has a value for every end-to-end
    quantity."""
    reg = Registry.load()
    cells = [c["name"] for c in reg.bench["workloads"]]
    ends = {e["name"]: e.get("workloads", cells)
            for e in reg.bench["end_to_end"]}
    for entry in reg.bench["per_layer"]:
        assert entry["moves"] in ends, entry["name"]
        assert set(entry.get("workloads", cells)) <= set(
            ends[entry["moves"]]), entry["name"]
    for cell in cells:
        assert "setup_s" in {e["name"] for e in reg.metrics_of(
            "end_to_end", cell)}
        assert len(reg.metrics_of("end_to_end", cell)) >= 2
        assert reg.metrics_of("per_layer", cell)
    assert {_quantity(n) for n in ends} <= {
        "mined_edges_per_s", "job_s_p95", "peak_mem_gib", "setup_s"}


def test_a_split_metric_reads_with_its_quantitys_file():
    reg = Registry.load()
    assert reg.metric("idle_pct.some_part") is reg.metric("idle_pct")
    with pytest.raises(KeyError):
        reg.metric("no_such_metric.some_part")


def test_unknown_names_raise():
    reg = Registry.load()
    with pytest.raises(KeyError):
        reg.cell("no_such.cell")
    with pytest.raises(KeyError):
        reg.config("no_such_config")


def test_new_parts_are_new_files(tmp_path):
    """A cell of a new configuration, mix, job kind and metric, all added
    as files in another folder, runs through the unchanged harness."""
    reg = small_registry(tmp_path)
    cfg = reg.config("small_kron21_bf")
    cfg.update(name="tiny_bf", scale=7, num_hashes=3)
    (tmp_path / "configs" / "tiny_bf.json").write_text(json.dumps(cfg))
    mix = {"job": "tc_only", "loop": "closed", "clients": 1,
           "traced_jobs": [0, 2], "checked_jobs": 1, "sample_below": 3}
    (tmp_path / "mixes" / "tc_only.json").write_text(json.dumps(mix))
    (tmp_path / "jobs").mkdir()
    (tmp_path / "jobs" / "tc_only.py").write_text(textwrap.dedent('''
        import torch
        from repro_torch.engine import api as engine
        from graphbench import checks
        from graphbench.reference import mining, sketches

        def run(ctx, seed, probe):
            cfg = ctx.config
            with probe.phase("build"):
                sess = engine.session(ctx.graph, cfg["sketch"],
                                      storage_budget=cfg["storage_budget"],
                                      num_hashes=cfg["num_hashes"],
                                      seed=seed, device=ctx.device)
            with probe.phase("tc"):
                return {"tc": float(sess.triangle_count())}

        def counters(out):
            return {"tc": out["tc"]}

        def keep(out):
            return out

        def reference(ctx, rg, seed, dtype):
            cfg = ctx.config
            words = sketches.bloom_words(rg.n, rg.m, cfg["storage_budget"])
            data = sketches.bloom(rg, words, cfg["num_hashes"], seed)
            _, cards = mining.edge_cardinalities(
                rg, "bf", data, {"total_bits": 32 * words,
                                 "num_hashes": cfg["num_hashes"]}, dtype)
            return {"tc": float(mining.triangle_count(cards))}

        def compare(got, want, rg):
            gap = abs(got["tc"] - want["tc"]) / abs(want["tc"])
            return [checks.Check("tc_gap", gap, 1e-4)]
    '''))
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "mean_tc.py").write_text(textwrap.dedent('''
        UNIT, LAYER, MOVES = "triangles", "algorithms", "mined_edges_per_s"

        def read(t):
            return sum(c["tc"] for c in t.job_counters) / len(t.job_counters)
    '''))
    reg.bench["configs"].append({"name": "tiny_bf"})
    reg.bench["workloads"].append({"name": "tiny_bf.tc_only",
                                   "config": "tiny_bf", "traffic": "tc_only",
                                   "chips": 1})
    reg.bench["per_layer"].append({
        "name": "mean_tc", "unit": "triangles", "better": "higher",
        "source": "program_counter", "layer": "algorithms",
        "moves": "mined_edges_per_s", "workloads": ["tiny_bf.tc_only"]})
    shipped = sorted(p.name for p in HERE.rglob("*") if p.is_file()
                     and "__pycache__" not in p.parts)
    plain = harness.run_cell("tiny_bf.tc_only", 5, 0.3, False,
                             registry=reg, device="cpu", log=lambda m: None)
    traced = harness.run_cell("tiny_bf.tc_only", 5, 0.3, True,
                              registry=reg, device="cpu", log=lambda m: None)
    assert plain["correct"] and traced["correct"]
    assert set(plain["checks"]) == {"csr_diff", "tc_gap"}
    assert "mean_tc" in traced["metrics"]
    assert traced["metrics"]["mean_tc"]["unit"] == "triangles"
    assert shipped == sorted(p.name for p in HERE.rglob("*") if p.is_file()
                             and "__pycache__" not in p.parts)
