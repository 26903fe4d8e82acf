"""One run of one cell: inputs from the seed, set-up, the measured window,
the per-layer reading of a traced run, and the check against the plain
reference.

The run is a closed loop of one client: jobs run back to back until
``seconds`` have passed, and the window ends when the last job that
started inside it has finished. Each job opens a new mining session with a
seed of its own (``job_seed``), so no job reuses another's sketch or
per-edge pass. The job kind's module (``jobs/<kind>.py``) makes the calls
into the program; this module owns the clock, the loop and the yardstick.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from . import checks, generator, profiling
from .reference import graph as ref_graph
from .registry import Registry

#: top-level module names of the JAX package and JAX, which no run loads
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def job_seed(seed: int, index: int) -> int:
    """The sketch seed of job ``index`` of a run (-1: the warm-up job)."""
    return generator.derive_seed(seed, "job", index) & 0x7FFFFFFF


@dataclasses.dataclass
class Context:
    """What a job kind's functions are given: the deployment, the traffic,
    the device and the program's graph."""

    config: dict
    mix: dict
    device: torch.device
    graph: object

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Probe:
    """Marks a job's phases. In a traced run each phase gets a host
    annotation (for the profiler) and a pair of device events (CUDA) or
    host clock readings (CPU); otherwise phases cost nothing."""

    def __init__(self, traced: bool, device: torch.device):
        self.traced = traced
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.traced:
            yield
            return
        with torch.profiler.record_function(profiling.PREFIX + name):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self.marks.setdefault(name, []).append((start, end))
            else:
                t = time.perf_counter()
                yield
                self.marks.setdefault(name, []).append(
                    time.perf_counter() - t)

    def phase_ms(self) -> Dict[str, List[float]]:
        """Milliseconds of each phase, one entry per job."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) for a, b in v]
                    for k, v in self.marks.items()}
        return {k: [s * 1e3 for s in v] for k, v in self.marks.items()}


@dataclasses.dataclass
class TraceData:
    """What the per-layer metric readers (``metrics/<name>.py``) read."""

    config: dict
    n: int
    m: int
    rows_named: int
    csr_build_s: float
    phase_ms: Dict[str, List[float]]
    spans: List[dict]
    device: Optional[profiling.DeviceTrace]
    job_counters: List[dict]    # of the profiled jobs


def _quantile(values: List[float], q: int) -> float:
    """The q-th percentile (inclusive method) of at least two values."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def loaded_forbidden() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def host_sample() -> tuple:
    """(wall clock, this process's CPU seconds), read around the window."""
    return time.perf_counter(), time.process_time()


def host_share(before: tuple, after: tuple) -> float:
    """The share of the wall clock between two ``host_sample``s that this
    process spent on a CPU: near 1 where the host paces the jobs."""
    return (after[1] - before[1]) / (after[0] - before[0])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             registry: Optional[Registry] = None, device: str = "cuda",
             t0: Optional[float] = None, log=None) -> dict:
    """Run ``workload`` once and return the result line's fields, with the
    compared numbers under ``checks``; the caller decides the platform."""
    from repro_torch.core.graph import from_edge_array
    from repro_torch.obs import trace as port_trace

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    reg = registry or Registry.load()
    cell = reg.cell(workload)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    job = reg.job(mix["job"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    # the cell's per-layer readers load now, so that the check for JAX
    # once the window has closed covers them too
    readers = {e["name"]: reg.metric(e["name"])
               for e in reg.metrics_of("per_layer", workload)}
    log(f"{time.perf_counter() - t0:.3f} s: imports done")

    # inputs: the raw edges, drawn on the device from the seed
    n = 1 << config["scale"]
    raw = generator.kronecker_edges(config, seed, dev)
    raw_host = raw.cpu().numpy()
    del raw
    log(f"{time.perf_counter() - t0:.3f} s: raw edges on the host")
    # set-up: the program's load path, then one warm-up job
    t = time.perf_counter()
    graph = from_edge_array(n, raw_host, device=dev)
    ctx = Context(config, mix, dev, graph)
    ctx.sync()
    csr_build_s = time.perf_counter() - t
    t = time.perf_counter()
    job.run(ctx, job_seed(seed, -1), Probe(False, dev))
    warm_s = time.perf_counter() - t
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s (n {graph.n}, m {graph.m}, "
        f"d_max {graph.d_max}, csr build {csr_build_s:.3f} s, warm-up job "
        f"{warm_s:.3f} s)")

    # the measured window
    # the checked jobs come after the traced ones, whose window the copy
    # of a checked job's answers to the host would otherwise enter
    first_traced, traced_jobs = mix["traced_jobs"]
    rng = random.Random(generator.derive_seed(seed, "sample"))
    sample = set(rng.sample(range(first_traced + traced_jobs,
                                  mix["sample_below"]), mix["checked_jobs"]))
    probe = Probe(trace, dev)
    prof, prof_t, prof_jobs = None, [0.0, 0.0], 0
    kept, durations, counters = {}, [], []
    if trace:
        port_trace.clear()
        port_trace.enable()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    host_before = host_sample()
    start = time.perf_counter()
    paused = 0.0    # seconds of the benchmark's own work inside the loop
    i = 0
    while time.perf_counter() - start - paused < seconds:
        if trace and i == first_traced:
            t = time.perf_counter()
            ctx.sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
            prof.start()
            prof_t[0] = time.perf_counter()
            paused += prof_t[0] - t
        t = time.perf_counter()
        with torch.profiler.record_function(profiling.PREFIX + "job") \
                if prof is not None else contextlib.nullcontext():
            out = job.run(ctx, job_seed(seed, i), probe)
        durations.append(time.perf_counter() - t)
        counters.append(job.counters(out))
        t = time.perf_counter()
        if i in sample:
            kept[i] = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                       for k, v in job.keep(out).items()}
        del out
        if prof is not None and prof_t[1] == 0.0:
            prof_jobs += 1
            if prof_jobs == traced_jobs:
                prof_t[1] = t
                prof.stop()
        paused += time.perf_counter() - t
        i += 1
    end = time.perf_counter()
    if prof is not None and prof_t[1] == 0.0:
        prof_t[1] = end
        prof.stop()
    window_s = end - start - paused
    host_after = host_sample()
    port_trace.disable()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    jobs = len(durations)
    log(f"window {window_s:.3f} s: {jobs} jobs, median "
        f"{statistics.median(durations):.4f} s, max {max(durations):.4f} s")
    log("job seconds: " + " ".join(f"{d:.4f}" for d in durations))
    log(f"host over the window: process on a CPU "
        f"{host_share(host_before, host_after):.3f} of the wall")

    bad = loaded_forbidden()
    if bad:
        raise ForbiddenModules(bad)

    # the check against the reference, with the program's state freed
    t = time.perf_counter()
    device_trace = (profiling.reduce(prof, prof_jobs, prof_t[1] - prof_t[0])
                    if prof is not None else None)
    del prof
    log(f"trace read in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    rg = ref_graph.build(n, torch.from_numpy(raw_host).to(dev))
    found = [graph_check(graph, rg)]
    ctx.graph = None
    del graph
    checked = sorted(kept)
    found += compare_jobs(job, ctx, rg, seed, kept)
    if not checked:
        found.append(checks.Check("checked_jobs", 0.0, -1.0))
    found = checks.merge(found)
    log(f"reference check {time.perf_counter() - t:.3f} s over jobs "
        f"{checked}")

    result = {
        "correct": all(c.ok for c in found),
        "attempted": jobs,
        "failed": 0,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(max(setup_peak, window_peak))},
    }
    if trace:
        data = TraceData(
            config=config, n=rg.n, m=rg.m,
            rows_named=int((rg.deg > 0).sum()), csr_build_s=csr_build_s,
            phase_ms=probe.phase_ms(), spans=port_trace.events(),
            device=device_trace,
            job_counters=counters[first_traced:first_traced + prof_jobs])
        for entry in reg.metrics_of("per_layer", workload):
            value = readers[entry["name"]].read(data)
            if value is not None:
                result["metrics"][entry["name"]] = {
                    "value": float(value), "unit": entry["unit"]}
        if data.device is not None and cuda:
            result["device"]["busy_s"] = data.device.busy_s
            result["device"]["window_s"] = data.device.window_s
            result["breakdown"] = {"device_ops": data.device.top_ops(),
                                   "idle_gaps": data.device.top_gaps()}
    else:
        values = {
            "mined_edges_per_s": rg.m * jobs / window_s,
            "job_s_p95": _quantile(durations, 95),
            "peak_mem_gib": window_peak / 2 ** 30,
            "setup_s": setup_s,
        }
        # a name "<quantity>.<part>" is the quantity, with a bound of its
        # own for the cells it lists
        for entry in reg.metrics_of("end_to_end", workload):
            result["metrics"][entry["name"]] = {
                "value": float(values[entry["name"].split(".")[0]]),
                "unit": entry["unit"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in found}
    return result


class ForbiddenModules(RuntimeError):
    """The run loaded JAX or the JAX package."""

    def __init__(self, names: List[str]):
        super().__init__(f"modules loaded that no run may load: {names}")
        self.names = names


def graph_check(graph, rg) -> checks.Check:
    """``csr_diff``: entries of the program's graph (sizes, CSR, degrees,
    edge list) that differ from the reference's."""
    bad = sum(int(a != b) for a, b in ((graph.n, rg.n), (graph.m, rg.m),
                                       (graph.d_max, rg.d_max)))
    for got, want in ((graph.indptr, rg.indptr), (graph.indices, rg.indices),
                      (graph.deg, rg.deg), (graph.edges, rg.edges)):
        bad += checks.mismatches(got.to(torch.int64), want)
    return checks.Check("csr_diff", float(bad), 0.0)


def compare_jobs(job, ctx: Context, rg, seed: int, kept: Dict[int, dict]
                 ) -> List[checks.Check]:
    """The compared numbers of the kept answers of jobs ``kept`` (index →
    answers) of a run of ``seed``, each against the float64 reference;
    each job's answers are dropped once compared."""
    found = []
    for index in sorted(kept):
        want = job.reference(ctx, rg, job_seed(seed, index), torch.float64)
        found += job.compare(kept.pop(index), want, rg)
    return found


def run_control(workload: str, seed: int, *, registry: Optional[Registry]
                = None, device: str = "cuda", jobs: int = 1) -> List[
                    checks.Check]:
    """The control: the reference computed in bfloat16, put in the
    program's place for the first ``jobs`` job seeds of a run and judged
    by the same comparison. A sound yardstick finds it not correct."""
    reg = registry or Registry.load()
    cell = reg.cell(workload)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    job = reg.job(mix["job"])
    dev = torch.device(device)
    n = 1 << config["scale"]
    raw = generator.kronecker_edges(config, seed, dev)
    rg = ref_graph.build(n, raw)
    ctx = Context(config, mix, dev, None)
    del raw
    found = []
    for i in range(jobs):
        s = job_seed(seed, i)
        got = job.reference(ctx, rg, s, torch.bfloat16)
        found += job.compare(got, job.reference(ctx, rg, s, torch.float64),
                             rg)
    return checks.merge(found)

