"""Streaming replay driver: timestamped edge deltas + interleaved queries.

Generates a Kronecker power-law graph, withholds a fraction of its edges as
a timestamped arrival stream, and replays them in delta batches against a
:class:`repro_torch.stream.StreamSession` — interleaving each delta with a
batched query flush (similarity / membership / link prediction / triangle
count / local clustering) through
:class:`repro_torch.stream.BatchedQueryServer`. Per batch it reports what
incremental maintenance saved (rows updated in place vs selectively rebuilt),
the host → device bytes the delta uploaded (proportional to the delta,
never a full-graph upload) and the servers' latency/staleness stats;
``--verify`` additionally checks every answer against a from-scratch
``engine.session`` on the equivalent static graph (exact match under the
default strict policy), and the maintained sketch and the device CSR
against fresh builds.

  python -m repro_torch.launch.stream --scale 16 --edge-factor 16 --batches 6 --verify

runs on the CUDA device (``--device cpu`` runs the plain PyTorch path).
With ``--checkpoint-dir`` the session is saved every ``--checkpoint-every``
batches, with the stream parameters; ``--restore`` resumes from the latest
checkpoint there, onto ``--device``, and refuses flags that would replay a
different stream. The last line printed is a machine-readable JSON summary.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import engine as ENG
from repro_torch._device import DEFAULT_DEVICE, resolve_device
from repro_torch.core import graph as G
from repro_torch.core import sketches as SK
from repro_torch.obs import metrics, trace
from repro_torch.stream import (BatchedQueryServer, DynamicGraph,
                                ErrorBudgetPolicy, StreamSession)


def split_stream(edges: np.ndarray, stream_frac: float, seed: int):
    """(initial edges, timestamped arrivals): a ``default_rng(seed + 1)``
    permutation of ``edges``, the last ``stream_frac`` of it withheld."""
    rng = np.random.default_rng(seed + 1)
    order = rng.permutation(edges.shape[0])  # arrival order == timestamp
    split = int((1.0 - stream_frac) * edges.shape[0])
    return edges[order[:split]], edges[order[split:]]


def build_stream(scale: int, edge_factor: int, stream_frac: float, seed: int,
                 device=DEFAULT_DEVICE):
    """Kronecker edges split into (n, initial graph, timestamped arrivals)."""
    g = G.kronecker(scale, edge_factor, seed=seed, device=device)
    initial, arrivals = split_stream(g.edges.cpu().numpy().astype(np.int64),
                                     stream_frac, seed)
    return g.n, initial, arrivals


def batch_deletes(st: StreamSession, rng, n_inserts: int,
                  delete_frac: float):
    """The batch's deletions: ``delete_frac`` × its inserts, drawn from the
    live edge set with the batch's rng (None when there are none)."""
    cur = st.dyn.edge_array()
    n_del = min(int(delete_frac * max(n_inserts, 1)), cur.shape[0])
    return (cur[rng.choice(cur.shape[0], size=n_del, replace=False)]
            if n_del else None)


def submit_queries(server: BatchedQueryServer, rng, n: int, queries: int):
    """The replay's five queries per batch, drawn from the batch's rng:
    ``queries`` Jaccard pairs, a membership test of 16, link prediction
    top 4, a local cluster at eps 1e-3 and TC (the fifth submit flushes
    when ``max_batch`` is 5). Returns what ``--verify`` compares and the
    request ids."""
    qpairs = rng.integers(0, n, size=(queries, 2)).astype(np.int32)
    sim_rid = server.submit_similarity(qpairs, "jaccard")
    mem_u = int(rng.integers(0, n))
    mem_cand = rng.integers(0, n, size=16)
    mem_rid = server.submit_membership(mem_u, mem_cand)
    lp_rid = server.submit_link_prediction(int(rng.integers(0, n)), top_k=4)
    lc_seed = int(rng.integers(0, n))
    lc_rid = server.submit_local_cluster(lc_seed, alpha=0.15, eps=1e-3)
    tc_rid = server.submit_triangle_count()
    return {"pairs": qpairs, "membership": (mem_u, mem_cand),
            "lc_seed": lc_seed,
            "rids": {"similarity": sim_rid, "membership": mem_rid,
                     "linkpred": lp_rid, "localcluster": lc_rid,
                     "tc": tc_rid}}


def verify_against_static(st: StreamSession, pairs: np.ndarray,
                          lc_seed: int | None = None,
                          membership=None) -> dict:
    """Every streamed answer against a from-scratch session on the
    equivalent static graph, with a fresh sketch of the stream's width and
    seed; also the maintained sketch rows against that fresh build and the
    device view's CSR against the static graph's. ``exact_match`` needs all
    of them equal (TC float32 bits included).

    The static session runs the plain PyTorch path (``use_kernel=False``)
    with the stream's plan otherwise: kernels and plain versions give the
    same integers, so on the card every kernel the stream launched (the
    refresh's and the pair batch's gather, the sweep's dense AND2, the
    MinHash counts) is held against its plain version on the stream's own
    rows and ids."""
    dev = st.dyn.torch_device
    gs = G.from_edge_array(st.dyn.n, st.dyn.edge_array(), device=dev)
    mt = st.maintainer
    sk = None
    if mt is not None:
        sk = SK.build(gs, mt.kind, words=mt.words or None, k=mt.k or None,
                      num_hashes=mt.num_hashes, seed=mt.seed)
    sess = ENG.session(gs, sk, plan=st.session.plan.with_(use_kernel=False),
                       device=dev)
    tc_static = float(sess.triangle_count())
    tc_stream = float(st.triangle_count())
    sim_static = sess.similarity(torch.from_numpy(pairs).to(gs.device),
                                 "jaccard").cpu().numpy()
    sim_stream = st.similarity(pairs, "jaccard").cpu().numpy()
    view = st.graph
    csr_equal = all(torch.equal(getattr(view, f), getattr(gs, f))
                    for f in ("indptr", "indices", "deg", "edges")) \
        and (view.n, view.m, view.d_max) == (gs.n, gs.m, gs.d_max)
    sketch_equal = (st.sketch is None
                    or (st.sketch.data.shape == sess.sketch.data.shape
                        and torch.equal(st.sketch.data, sess.sketch.data)))
    exact = (np.float32(tc_stream).tobytes() == np.float32(tc_static)
             .tobytes()
             and np.array_equal(sim_stream, sim_static)
             and csr_equal and sketch_equal)
    out = {
        "tc_abs_err": abs(tc_stream - tc_static),
        "sim_max_err": float(np.max(np.abs(sim_stream - sim_static)))
        if pairs.size else 0.0,
        "csr_equal": csr_equal,
        "sketch_equal": sketch_equal,
    }
    if membership is not None:
        u, cand = membership
        sk = sess.sketch
        if sk is not None and sk.kind == "bf":
            want = SK.bloom_membership(
                sk.data[u], torch.from_numpy(np.asarray(cand, np.int32))
                .to(gs.device), gs.n, sk.num_hashes, sk.total_bits, sk.seed)
        else:
            want = torch.from_numpy(np.isin(cand, G.neighbors_np(gs, u)))
        mem_equal = torch.equal(st.membership(u, cand).cpu(), want.cpu())
        out["membership_equal"] = mem_equal
        exact = exact and mem_equal
    if lc_seed is not None:
        seeds = np.array([lc_seed], np.int32)
        lc_static = sess.local_cluster(seeds, alpha=0.15, eps=1e-3)
        lc_stream = st.local_cluster(seeds, alpha=0.15, eps=1e-3)
        a = float(lc_static.best_conductance[0])
        b = float(lc_stream.best_conductance[0])
        out["lc_phi_abs_err"] = 0.0 if a == b else abs(a - b)
        exact = exact and torch.equal(lc_static.conductance,
                                      lc_stream.conductance) \
            and torch.equal(lc_static.order, lc_stream.order)
    out["exact_match"] = bool(exact)
    return out


def main(argv=None):
    """CLI: generate, split, replay with interleaved queries; prints one
    line per batch and a JSON summary last."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=10, help="Kronecker scale")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--kind", default="bf",
                    choices=["bf", "kh", "1h", "kmv", "exact"])
    ap.add_argument("--budget", type=float, default=0.25)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--stream-frac", type=float, default=0.3,
                    help="fraction of edges withheld as the arrival stream")
    ap.add_argument("--delete-frac", type=float, default=0.1,
                    help="deletions per batch as a fraction of its inserts")
    ap.add_argument("--queries", type=int, default=64,
                    help="similarity pairs per interleaved query batch")
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="error-budget rel_tolerance (0 = strict/bit-exact)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the serving-tier result cache")
    ap.add_argument("--async-serving", action="store_true",
                    help="run the server's background flush worker: deltas "
                         "overlap query service on snapshot-isolated views")
    ap.add_argument("--verify", action="store_true",
                    help="check answers against a from-scratch static session")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="record spans and write a Chrome-trace/Perfetto "
                         "JSON of the replay to this path")
    ap.add_argument("--metrics", action="store_true",
                    help="embed metric-registry snapshots in the summary")
    args = ap.parse_args(argv)

    if args.restore and not args.checkpoint_dir:
        raise SystemExit("--restore requires --checkpoint-dir")
    resolve_device(args.device)
    if args.trace:
        trace.enable()
        trace.clear()
    n, initial, arrivals = build_stream(args.scale, args.edge_factor,
                                        args.stream_frac, args.seed,
                                        args.device)
    kind = None if args.kind == "exact" else args.kind
    # the stream is regenerated from these parameters on restore: any drift
    # would replay wrong or duplicate arrival chunks, so they are stored
    # with every checkpoint and checked here
    stream_cfg = {"scale": args.scale, "edge_factor": args.edge_factor,
                  "stream_frac": args.stream_frac, "batches": args.batches,
                  "seed": args.seed, "kind": args.kind}
    if args.restore:
        st = StreamSession.restore(args.checkpoint_dir, device=args.device)
        if st.extra and st.extra != stream_cfg:
            raise SystemExit(
                f"checkpoint stream config {st.extra} does not match the "
                f"requested flags {stream_cfg}; rerun with matching flags")
        print(f"restored: version={st.version} n={st.dyn.n} m={st.dyn.m}")
    else:
        st = StreamSession(
            DynamicGraph.from_edges(n, initial, device=args.device),
            kind=kind, storage_budget=args.budget,
            policy=ErrorBudgetPolicy(rel_tolerance=args.tolerance))
    # admission policy: the five per-batch queries below auto-flush on the
    # fifth submit (max_batch); max_wait_s keeps a straggler batch from
    # waiting forever under other traffic shapes
    server = BatchedQueryServer(st, max_batch=5, max_wait_s=0.25,
                                cache=not args.no_cache,
                                async_flush=args.async_serving)
    chunks = np.array_split(arrivals, args.batches)
    print(f"stream: n={n} initial_m={st.dyn.m} arrivals={arrivals.shape[0]} "
          f"batches={args.batches} kind={args.kind} device={args.device}")

    _ = st.session.edge_cardinalities()  # warm the shared pass
    batch_rows = []
    for b in range(st.version, args.batches):
        # per-batch rng keyed on (seed, b), as the reference draws them: a
        # restored run draws what the uninterrupted run would at batch b
        rng = np.random.default_rng([args.seed + 2, b])
        ins = chunks[b]
        dels = batch_deletes(st, rng, len(ins), args.delete_frac)
        t0 = time.perf_counter()
        info = st.apply_delta(ins, dels)
        dt_delta = time.perf_counter() - t0

        t0 = time.perf_counter()
        q = submit_queries(server, rng, n, args.queries)
        answers = server.flush()                 # already answered; drains
        dt_query = time.perf_counter() - t0

        lc = answers[q["rids"]["localcluster"]].value
        row = {"batch": b, "m": st.dyn.m, "delta_s": round(dt_delta, 4),
               "query_s": round(dt_query, 4),
               "tc": answers[q["rids"]["tc"]].value,
               "localcluster": {"size": lc["size"],
                                "conductance": lc["conductance"]},
               **info}
        if args.verify:
            row["verify"] = verify_against_static(st, q["pairs"],
                                                  q["lc_seed"],
                                                  q["membership"])
        batch_rows.append(row)
        print(f"[{b:03d}] m={row['m']} +{info['inserted']} -{info['deleted']} "
              f"tc={row['tc']:.1f} recomputed={info['cards_recomputed']}"
              f"/carried={info['cards_carried']} "
              f"rebuilt={info['rows_rebuilt_now']} "
              f"lc(|C|={lc['size']},phi={lc['conductance']:.3f}) "
              f"upload={info['bytes_uploaded'] / 1024:.1f}KiB "
              f"delta={dt_delta*1e3:.1f}ms query={dt_query*1e3:.1f}ms"
              + (f" exact={row['verify']['exact_match']}" if args.verify
                 else ""))
        if args.checkpoint_dir and (b + 1) % args.checkpoint_every == 0:
            path = st.save(args.checkpoint_dir, extra=stream_cfg)
            print(f"      checkpoint -> {path}")

    server_stats = server.stats()   # before close(), which drops the cache
    server.close()                  # flush-then-detach
    summary = {"event": "stream_replay", "n": n, "final_m": st.dyn.m,
               "batches": len(batch_rows), "device": str(st.dyn.torch_device),
               # the TC served after the last batch replayed here
               "last_tc": batch_rows[-1]["tc"] if batch_rows else None,
               "stream": st.stats(), "server": server_stats,
               # null (not a vacuous true) when no batch was verified
               "verify_all_exact": all(r["verify"]["exact_match"]
                                       for r in batch_rows)
               if args.verify and batch_rows else None}
    if args.metrics:
        summary["metrics"] = {"global": metrics.REGISTRY.snapshot(),
                              "stream": st.metrics.snapshot(),
                              "server": server.metrics.snapshot()}
    if args.trace:
        trace.export(args.trace)
        trace.disable()
        summary["trace"] = args.trace
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
