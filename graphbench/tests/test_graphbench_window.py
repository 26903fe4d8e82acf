"""The end-to-end numbers: the rate is all work over all the window's time,
and a stalled job moves the tail."""
import json
import textwrap

import pytest

from smallbench import small_registry
from graphbench import generator, harness
from graphbench.reference import graph as ref_graph

STEP_S = 0.01
STALL_S = 0.1


@pytest.fixture
def sleeper(tmp_path):
    """A cell whose job sleeps STEP_S, and STALL_S in the jobs of the
    module-level list ``STALLED``."""
    reg = small_registry(tmp_path)
    (tmp_path / "jobs").mkdir()
    (tmp_path / "jobs" / "sleep.py").write_text(textwrap.dedent(f'''
        import time
        from graphbench import checks
        STALLED = []
        CALLS = [0]

        def run(ctx, seed, probe):
            CALLS[0] += 1
            time.sleep({STALL_S} if CALLS[0] - 1 in STALLED else {STEP_S})
            return {{}}

        def counters(out):
            return {{}}

        def keep(out):
            return out

        def reference(ctx, rg, seed, dtype):
            return {{}}

        def compare(got, want, rg):
            return [checks.Check("nothing", 0.0, 0.0)]
    '''))
    mix = {"job": "sleep", "loop": "closed", "clients": 1,
           "traced_jobs": [0, 1], "checked_jobs": 1, "sample_below": 3}
    (tmp_path / "mixes" / "sleep.json").write_text(json.dumps(mix))
    reg.bench["workloads"].append({"name": "small_kron21_bf.sleep",
                                   "config": "small_kron21_bf",
                                   "traffic": "sleep", "chips": 1})
    for entry in reg.bench["end_to_end"]:
        if entry["name"] == "mined_edges_per_s":
            entry["workloads"].append("small_kron21_bf.sleep")
    # the tail and a split of the rate, as a later cell would list them
    for name, unit in (("job_s_p95", "s"),
                       ("mined_edges_per_s.sleep", "edges/s")):
        reg.bench["end_to_end"].append({
            "name": name, "unit": unit, "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": ["small_kron21_bf.sleep"]})
    return reg


def _run(reg, stalled):
    job = reg.job("sleep")
    job.STALLED[:] = stalled
    job.CALLS[0] = 0
    return harness.run_cell("small_kron21_bf.sleep", 9, 0.6, False,
                            registry=reg, device="cpu", log=lambda m: None)


def test_rate_counts_all_work_over_all_time(sleeper):
    cfg = sleeper.config("small_kron21_bf")
    raw = generator.kronecker_edges(cfg, 9, "cpu")
    m = ref_graph.build(1 << cfg["scale"], raw).m
    clean = _run(sleeper, [])
    rate = clean["metrics"]["mined_edges_per_s"]["value"]
    # a closed loop of STEP_S jobs: m edges every STEP_S, less overhead
    assert 0.7 * m / STEP_S < rate <= m / STEP_S
    # job 0 of the window is the warm-up's successor: calls count the
    # warm-up first, so call 2 is window job 1
    stalled = _run(sleeper, [2])
    jobs = stalled["attempted"]
    got = stalled["metrics"]["mined_edges_per_s"]["value"]
    want = m * jobs / (jobs * STEP_S + STALL_S)
    assert got == pytest.approx(want, rel=0.3)
    assert got < rate * 0.9


def test_a_split_reports_its_quantity(sleeper):
    out = _run(sleeper, [])["metrics"]
    assert out["mined_edges_per_s.sleep"] == out["mined_edges_per_s"]
    assert out["job_s_p95"]["unit"] == "s"


def test_stalled_jobs_move_the_tail(sleeper):
    """One job in eight stalls: more than the 5% beyond the 95th
    percentile, so the tail reads the stall."""
    clean = _run(sleeper, [])["metrics"]["job_s_p95"]["value"]
    stalled = _run(sleeper, list(range(2, 200, 8)))
    assert clean < 2 * STEP_S
    assert stalled["metrics"]["job_s_p95"]["value"] > 0.9 * STALL_S
