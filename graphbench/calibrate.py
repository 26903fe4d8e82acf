"""Readings behind the limits of ``correct``, many seeds in one process.

    python3 graphbench/calibrate.py --workload kron24_bf.tc_lcc \
        --seeds 11,12,13 --control-seeds 21,22,23 [--jobs 1]

For each of ``--seeds``: the graph of that seed, loaded by the program,
one warm-up job, then ``--jobs`` jobs through the timed path's own call
(``jobs/<kind>.py``'s ``run``), each compared with the reference exactly
as a run compares its checked jobs. A cell of k > 1 chips reads each seed
on k new ranks, as a run does. For each of ``--control-seeds``: the
control, the reference computed in bfloat16 in the program's place. One
JSON line per reading, then the largest reading of the program and the
smallest of the control per compared number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from graphbench import harness, ranks  # noqa: E402
from graphbench.registry import Registry  # noqa: E402


def program_readings(reg, workload, seed, jobs, device):
    """The compared numbers of ``jobs`` jobs of the program on one seed,
    on the cell's ranks."""
    return harness.over_ranks(_readings, reg, workload, device,
                              (reg, workload, seed, jobs))


def _readings(dev, reg, workload, seed, jobs):
    group = ranks.Group(dev)
    cell = reg.cell(workload)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    job = reg.job(mix["job"])
    ctx = harness.new_context(config, mix, dev, group)
    harness.refuse_unsharded(job, mix, group.world)
    share = harness.draw_share(ctx, seed)
    ctx.graph = harness.load_graph(job, ctx, share)
    job.run(ctx, harness.job_seed(seed, -1), harness.Probe(False, dev))
    kept = {}
    for i in range(jobs):
        out = job.run(ctx, harness.job_seed(seed, i), harness.Probe(False,
                                                                     dev))
        kept[i] = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                   for k, v in job.keep(out).items()}
        del out
    rg = harness.reference_graph(ctx, group, share)
    return harness.merge_ranks(group, harness.check_rank(job, ctx, rg, seed,
                                                         kept))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reg = Registry.load()
    worst, least = {}, {}
    for side, seeds in (("program", args.seeds), ("control",
                                                  args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.perf_counter()
            if side == "program":
                found = program_readings(reg, args.workload, seed,
                                         args.jobs, args.device)
            else:
                found = harness.run_control(args.workload, seed,
                                            registry=reg,
                                            device=args.device,
                                            jobs=args.jobs)
            line = {c.name: c.value for c in found}
            print(json.dumps({"side": side, "seed": seed,
                              "seconds": time.perf_counter() - t,
                              "readings": line}), flush=True)
            for name, value in line.items():
                if side == "program":
                    worst[name] = max(worst.get(name, value), value)
                else:
                    least[name] = min(least.get(name, value), value)
            # (the ranks of a cell over several cards have ended)
            if args.device == "cuda" and int(
                    reg.cell(args.workload)["chips"]) == 1:
                torch.cuda.empty_cache()
    print(json.dumps({"program_largest": worst, "control_smallest": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
