"""One run of one cell: inputs from the seed, set-up, the measured window,
the per-layer reading of a traced run, and the check against the plain
reference.

The run is a closed loop of one client: jobs run back to back until
``seconds`` have passed, and the window ends when the last job that
started inside it has finished. Each job opens a new mining session with a
seed of its own (``job_seed``), so no job reuses another's sketch or
per-edge pass. The job kind's module (``jobs/<kind>.py``) makes the calls
into the program; this module owns the clock, the loop and the yardstick.

A cell whose ``chips`` is k > 1 runs as k ranks, one a card
(``ranks.py``). Every rank draws the raw edges and keeps its share of
them, the rows [r·E/k, (r+1)·E/k) (its part of a partitioned input file);
the job kind's ``load`` makes the rank's graph of it. Rank 0 owns the
clock: before each job it tells every rank whether the job starts, and
the window closes once the last job has finished on every rank. Each rank
checks its own answers against the reference's rows of its vertex range
(``reference.graph.build_range``), built from every rank's share of the
raw edges (``range_edges``); rank 0 gathers the checks (worst over the
ranks), the memory peaks (the largest), the traces and each rank's last
look for JAX, and returns the result. A cell of one card starts no
process and no group.
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

from . import checks, generator, profiling, ranks
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
    the device and the program's graph; and this rank's place among the
    cell's ``world`` ranks with its ``vertex_range`` [lo, hi)."""

    config: dict
    mix: dict
    device: torch.device
    graph: object
    rank: int = 0
    world: int = 1
    vertex_range: tuple = (0, 0)

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
    """What the per-layer metric readers (``metrics/<name>.py``) read.

    ``n``, ``m`` and ``rows_named`` are the whole graph's, summed over the
    ranks; ``csr_build_s`` is the largest over them. ``phase_ms``,
    ``spans``, ``device`` and ``job_counters`` are rank 0's alone, and
    every rank's trace is in ``rank_devices`` and ``rank_spans``. Over
    ``world`` > 1 ranks a reader that counts work from the whole graph
    divides it by rank 0's device time, so it reads nothing there."""

    config: dict
    n: int
    m: int
    rows_named: int
    csr_build_s: float
    phase_ms: Dict[str, List[float]]
    spans: List[dict]
    device: Optional[profiling.DeviceTrace]
    job_counters: List[dict]    # of the profiled jobs
    world: int = 1
    # every rank's, in rank order; ``device`` and ``spans`` are rank 0's
    rank_devices: List[Optional[profiling.DeviceTrace]] = \
        dataclasses.field(default_factory=list)
    rank_spans: List[List[dict]] = dataclasses.field(default_factory=list)


def _quantile(values: List[float], q: int) -> float:
    """The q-th percentile (inclusive method) of at least two values."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def vertex_range(n: int, world: int, rank: int) -> tuple:
    """Vertices [lo, hi) of rank ``rank``: blocks of ceil(n / world), the
    last one cut at n (the rule of the program's ``launch/mine.py``)."""
    block = -(-n // world)
    lo = min(n, rank * block)
    return lo, min(n, lo + block)


def edge_share(raw: torch.Tensor, world: int, rank: int) -> torch.Tensor:
    """Rows [r·E/k, (r+1)·E/k) of the raw edges: rank r's part of them,
    the shares in rank order making up the whole."""
    e = raw.shape[0]
    return raw[rank * e // world:(rank + 1) * e // world]


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
    compared numbers under ``checks``; the caller decides the platform.
    A cell of k > 1 chips runs on k new ranks of ``device``'s type, which
    log to standard error (``log`` serves a cell of one card)."""
    t0 = time.perf_counter() if t0 is None else t0
    reg = registry or Registry.load()
    if int(reg.cell(workload)["chips"]) > 1:
        log = None      # the ranks log to standard error
    return over_ranks(_cell, reg, workload, device,
                      (workload, seed, seconds, trace, reg, t0, log))


def over_ranks(fn, reg: Registry, workload: str, device: str, args: tuple):
    """``fn(device, *args)`` on the cell's ranks: in this process for a
    cell of one card, else on its k new ranks; rank 0's return value."""
    world = int(reg.cell(workload)["chips"])
    if world == 1:
        return fn(torch.device(device), *args)
    return ranks.launch(fn, world, args, device=device)


def _cell(dev: torch.device, workload: str, seed: int, seconds: float,
          trace: bool, reg: Registry, t0: float, log) -> Optional[dict]:
    """One rank's part of a run (the whole run on one card): the result
    on rank 0, None on the others."""
    from repro_torch.obs import trace as port_trace

    group = ranks.Group(dev)
    log = log or _stderr_log(group)
    cell = reg.cell(workload)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    job = reg.job(mix["job"])
    cuda = dev.type == "cuda"
    ctx = new_context(config, mix, dev, group)
    refuse_unsharded(job, mix, group.world)
    # the cell's per-layer readers load now, so that the check for JAX
    # once the window has closed covers them too
    readers = {e["name"]: reg.metric(e["name"])
               for e in reg.metrics_of("per_layer", workload)}
    log(f"{time.perf_counter() - t0:.3f} s: imports done")

    # inputs: the raw edges, drawn on the device from the seed; this
    # rank's share of them on the host
    share = draw_share(ctx, seed)
    log(f"{time.perf_counter() - t0:.3f} s: raw edges on the host")
    # set-up: the program's load path, then one warm-up job
    t = time.perf_counter()
    ctx.graph = load_graph(job, ctx, share)
    ctx.sync()
    csr_build_s = time.perf_counter() - t
    t = time.perf_counter()
    job.run(ctx, job_seed(seed, -1), Probe(False, dev))
    warm_s = time.perf_counter() - t
    group.barrier()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s ({_describe(ctx.graph)}, csr build "
        f"{csr_build_s:.3f} s, warm-up job {warm_s:.3f} s)")

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
    # rank 0's clock decides, for every rank, whether job i starts
    while group.agree(time.perf_counter() - start - paused < seconds):
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
    # the window closes once the last job has finished on every rank
    group.barrier()
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
    rg = reference_graph(ctx, group, share)
    checked = sorted(kept)
    found = check_rank(job, ctx, rg, seed, kept)
    log(f"reference check {time.perf_counter() - t:.3f} s over jobs "
        f"{checked}")
    traces = group.gather((device_trace, port_trace.events(),
                           int((rg.deg > 0).sum()))) if trace else None
    # each rank looks for JAX again once its part of the run is done
    reports = group.gather({
        "attempted": jobs, "m": rg.m, "csr_build_s": csr_build_s,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
        "window_peak": window_peak, "checks": found,
        "forbidden": loaded_forbidden()})
    if group.rank != 0:
        return None
    attempted = [r["attempted"] for r in reports]
    if len(set(attempted)) != 1:
        raise RuntimeError(f"the ranks ran different jobs: {attempted}")
    m = sum(r["m"] for r in reports)
    found = checks.merge(c for r in reports for c in r["checks"])

    result = {
        "correct": all(c.ok for c in found),
        "attempted": jobs,
        "failed": 0,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": group.world,
                   "memory_peak_bytes": max(r["memory_peak_bytes"]
                                            for r in reports)},
    }
    if trace:
        data = TraceData(
            config=config, n=rg.n, m=m,
            rows_named=sum(x[2] for x in traces),
            csr_build_s=max(r["csr_build_s"] for r in reports),
            phase_ms=probe.phase_ms(), spans=traces[0][1],
            device=traces[0][0],
            job_counters=counters[first_traced:first_traced + prof_jobs],
            world=group.world, rank_devices=[x[0] for x in traces],
            rank_spans=[x[1] for x in traces])
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
            "mined_edges_per_s": m * jobs / window_s,
            "job_s_p95": _quantile(durations, 95),
            "peak_mem_gib": max(r["window_peak"] for r in reports) / 2 ** 30,
            "setup_s": setup_s,
        }
        # a name "<quantity>.<part>" is the quantity, with a bound of its
        # own for the cells it lists
        for entry in reg.metrics_of("end_to_end", workload):
            result["metrics"][entry["name"]] = {
                "value": float(values[entry["name"].split(".")[0]]),
                "unit": entry["unit"]}
    if group.world > 1:
        result["ranks"] = {"attempted": attempted,
                           "memory_peak_bytes": [r["memory_peak_bytes"]
                                                 for r in reports]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in found}
    # and rank 0 once more, after the readers
    bad = sorted(set(loaded_forbidden()).union(
        *(r["forbidden"] for r in reports)))
    if bad:
        raise ForbiddenModules(bad)
    return result


def _stderr_log(group: ranks.Group):
    prefix = f"rank {group.rank}: " if group.world > 1 else ""
    return lambda msg: print(prefix + msg, file=sys.stderr, flush=True)


def _describe(graph) -> str:
    return ", ".join(f"{k} {getattr(graph, k)}" for k in ("n", "m", "d_max")
                     if hasattr(graph, k))


def new_context(config: dict, mix: dict, dev: torch.device,
                group: ranks.Group) -> Context:
    """The context of this rank, with no graph yet."""
    n = 1 << config["scale"]
    return Context(config, mix, dev, None, group.rank, group.world,
                   vertex_range(n, group.world, group.rank))


def refuse_unsharded(job, mix: dict, world: int) -> None:
    """A cell over several cards needs a job kind that loads a rank's
    graph (``load``) and checks it (``check_graph``)."""
    missing = [f for f in ("load", "check_graph") if not hasattr(job, f)]
    if world > 1 and missing:
        raise ValueError(f"job kind {mix['job']!r} has no {missing}: a "
                         f"cell of {world} chips needs both")


def draw_share(ctx: Context, seed: int):
    """This rank's share of the raw edges of ``seed``, drawn on the
    device and held on the host (numpy int64[E/k, 2])."""
    raw = generator.kronecker_edges(ctx.config, seed, ctx.device)
    return edge_share(raw, ctx.world, ctx.rank).cpu().numpy()


def load_graph(job, ctx: Context, share):
    """The program's graph of this rank: the job kind's ``load``, else
    ``from_edge_array`` of the whole graph."""
    if hasattr(job, "load"):
        return job.load(ctx, share)
    from repro_torch.core.graph import from_edge_array

    return from_edge_array(1 << ctx.config["scale"], share,
                           device=ctx.device)


def reference_graph(ctx: Context, group: ranks.Group, share
                    ) -> ref_graph.RefGraph:
    """The reference's graph: on one card, of the raw edges held; on k,
    of this rank's vertex range, from the raw edges that touch it."""
    n = 1 << ctx.config["scale"]
    if ctx.world == 1:
        return ref_graph.build(n, torch.from_numpy(share).to(ctx.device))
    return ref_graph.build_range(n, range_edges(ctx, group, share),
                                 *ctx.vertex_range)


def range_edges(ctx: Context, group: ranks.Group, share) -> torch.Tensor:
    """The raw edges that touch this rank's vertex range, on its device:
    each rank's share of them (held on the host since the draw) sent in
    turn to every rank, which keeps what touches its range. No rank holds
    all the raw edges, and none draws them again."""
    parts = []
    for src in range(group.world):
        rows = group.broadcast_rows(
            torch.from_numpy(share).to(ctx.device) if src == group.rank
            else None, src)
        parts.append(ref_graph.touching(rows, *ctx.vertex_range))
        del rows
    return torch.cat(parts)


def check_rank(job, ctx: Context, rg, seed: int, kept: Dict[int, dict]
               ) -> List[checks.Check]:
    """This rank's compared numbers: its graph (the job kind's
    ``check_graph``, else ``graph_check``), then, with the program's graph
    freed, the kept answers (``kept`` is emptied)."""
    if hasattr(job, "check_graph"):
        found = list(job.check_graph(ctx, ctx.graph, rg))
    else:
        found = [graph_check(ctx.graph, rg)]
    ctx.graph = None
    if not kept:
        found.append(checks.Check("checked_jobs", 0.0, -1.0))
    found += compare_jobs(job, ctx, rg, seed, kept)
    return checks.merge(found)


def merge_ranks(group: ranks.Group, found: List[checks.Check]
                ) -> Optional[List[checks.Check]]:
    """Every rank's checks, worst over the ranks, on rank 0; None on the
    others."""
    parts = group.gather(found)
    if group.rank != 0:
        return None
    return checks.merge(c for part in parts for c in part)


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
                = None, device: str = "cuda", jobs: int = 1
                ) -> List[checks.Check]:
    """The control: the reference computed in bfloat16, put in the
    program's place for the first ``jobs`` job seeds of a run and judged
    by the same comparison, on the cell's ranks. A sound yardstick finds
    it not correct."""
    reg = registry or Registry.load()
    return over_ranks(_control, reg, workload, device,
                      (workload, seed, reg, jobs))


def _control(dev: torch.device, workload: str, seed: int, reg: Registry,
             jobs: int) -> Optional[List[checks.Check]]:
    group = ranks.Group(dev)
    cell = reg.cell(workload)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    job = reg.job(mix["job"])
    ctx = new_context(config, mix, dev, group)
    n = 1 << config["scale"]
    raw = generator.kronecker_edges(config, seed, dev)
    rg = (ref_graph.build(n, raw) if group.world == 1
          else ref_graph.build_range(n, raw, *ctx.vertex_range))
    del raw
    found = []
    for i in range(jobs):
        s = job_seed(seed, i)
        got = job.reference(ctx, rg, s, torch.bfloat16)
        found += job.compare(got, job.reference(ctx, rg, s, torch.float64),
                             rg)
    return merge_ranks(group, checks.merge(found))
