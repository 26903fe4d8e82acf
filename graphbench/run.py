"""Run one cell of ``BENCHMARK.json`` once on the GPU.

    python3 graphbench/run.py --workload kron24_bf.tc_lcc --seed 7 \
        --seconds 40 --trace 0

Prints the compared numbers beside their limits as the last lines of
standard error and one JSON object as the last line of standard output.
A cell of k > 1 chips runs as k ranks, one a GPU (``ranks.py``), and this
process prints rank 0's result once every rank has ended. Exits non-zero,
printing no result, when the cell's GPUs are missing, the run loaded JAX
or the JAX package, or a rank failed or outlived the run's deadline.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from graphbench.registry import ROOT, Registry  # noqa: E402

#: kernel caches of the program and its libraries, at fixed paths inside
#: the checkout (git ignores build/)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/graphbench_cache/torch_extensions",
          "TRITON_CACHE_DIR": "build/graphbench_cache/triton"}


def _number(x):
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(ROOT / path)

    import torch
    from graphbench import harness, ranks

    reg = Registry.load()
    chips = int(reg.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), registry=reg, t0=T0)
    except harness.ForbiddenModules as err:
        print(f"refused: {err}", file=sys.stderr)
        return 3
    except ranks.RankFailure as err:
        print(f"failed: {err}", file=sys.stderr)
        return 4
    # again just before the result: whatever loaded after the window
    bad = harness.loaded_forbidden()
    if bad:
        print(f"refused: {harness.ForbiddenModules(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    result["checks"] = {k: {"value": _number(c["value"]),
                            "limit": _number(c["limit"])}
                        for k, c in result["checks"].items()}
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
