"""What one rank computes on the sharded mining path, for comparison with
a one-process run.

``rank_report`` is a rank entry for :func:`repro_torch.distributed.spawn`:
every rank builds the same Kronecker graph, lays a ("data", "model") mesh
over the process group and runs the path's entry points on it — the
vertex-sharded Bloom build, ``mine()``, the engine's edge-sharded fold
(``shard_edges=True`` under ``use_rules``) and, given a checkpoint, the
sharded restore. It returns plain numpy and Python values, so the caller
can hold them against the JAX package's results.

    spawn(rank_report, 4, args=(10, 16, (2, 2), "cpu", 1000, ckpt))
"""
from __future__ import annotations

from typing import Optional

from ..core import graph as G
from ..core import sketches as SK
from ..core.algorithms.tc import triangle_count
from ..engine import session
from . import sharding


def rank_report(scale: int, edge_factor: int, mesh_shape: tuple,
                device: str, edge_chunk: int,
                checkpoint: Optional[tuple] = None,
                storage_budget: float = 0.25) -> dict:
    """This rank's results on ``kronecker(scale, edge_factor, seed=1)``
    over a (data, model) = ``mesh_shape`` mesh.

    ``rows``: ``build_sketches_distributed`` at the budget's words (2
    hashes, seed 0); ``mine``: ``mine()``'s keys; ``tc``: {degree_order:
    the Bloom TC with ``shard_edges=True`` and ``edge_chunk`` under
    ``use_rules(mesh)``}; ``restore``: with ``checkpoint = (directory,
    step, target, axes)`` (a tree of numpy targets and one of logical
    axes), per leaf key its ``spec``, its ``local`` shard and the
    ``full`` tensor as numpy.
    """
    from ..launch import mesh as LM
    from ..launch import mine as LMINE

    mesh = LM.make_host_mesh(*mesh_shape, device=device)
    g = G.kronecker(scale, edge_factor, seed=1, device=device)
    words = SK.bloom_words_for_budget(g.n, g.m, storage_budget)
    out = {"coordinate": tuple(mesh.get_coordinate()), "words": words,
           "rows": LMINE.build_sketches_distributed(
               g, mesh, words, 2, 0).cpu().numpy(),
           "mine": LMINE.mine(g, mesh, storage_budget=storage_budget,
                              device=device),
           "tc": {}}
    for degree_order in (False, True):
        sess = session(g, "bf", storage_budget=storage_budget, device=device,
                       edge_chunk=edge_chunk, degree_order=degree_order,
                       shard_edges=True)
        with sharding.use_rules(mesh):
            out["tc"][degree_order] = float(
                triangle_count(g, sess.sketch, plan=sess.plan))
    if checkpoint is not None:
        from ..checkpoint import restore_checkpoint

        directory, step, target, axes = checkpoint
        shardings = sharding.sharding_for_tree(axes, target, mesh)
        tree = restore_checkpoint(directory, step, target, shardings)
        out["restore"] = {
            key: {"spec": shardings[key].spec,
                  "local": leaf.to_local().cpu().numpy(),
                  "full": leaf.full_tensor().cpu().numpy()}
            for key, leaf in tree.items()}
    return out
