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

``moe_report`` does the same for the MoE layer over a mesh (the
expert-parallel ``moe_fwd_ep`` and the sharded ``moe_fwd``): its output
and gradients, gathered. ``train_step_report`` runs one train step on a
given state laid out by ``train_state_shardings``, and ``decode_report``
decode steps over a cache laid out by ``cache_shardings`` (split over
positions): their losses, gradients, parameters and logits, gathered.
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


def moe_report(cases, device: str) -> list:
    """Each case's MoE output on this rank's mesh: ``case`` holds
    ``mesh`` ((shape, dim names) over the group's ranks), ``cfg`` (a port
    ``ModelConfig``), ``params`` (numpy weights under ``MoE``'s names,
    ``shared.*`` for the shared expert), ``x`` (numpy [B, S, d]) and
    ``probe`` (numpy [B, S, d]). The layer runs on DTensors laid out by
    their logical axes under ``use_rules(mesh)``
    (``moe_impl`` of the config); returns per case ``y`` (the gathered
    output) and ``grads`` (of Σ y · probe: ``x`` and each weight by
    name, gathered), as numpy."""
    import torch

    from ..launch.mesh import _init_mesh
    from ..models import layers as L
    from ..models.model import _moe, _sublayer_axes

    out = []
    for case in cases:
        cfg = case["cfg"]
        mesh = _init_mesh(device, *case["mesh"])
        axes = {k[len("ffn."):]: v for k, v in
                _sublayer_axes(cfg, ("attn", "moe")).items()
                if k.startswith("ffn.")}
        layer = L.MoE(cfg, None, device)
        for name, p in list(layer.named_parameters()):
            full = torch.from_numpy(case["params"][name]).to(device)
            sh = sharding.NamedSharding(mesh, sharding.spec_for(
                axes[name], full.shape, mesh))
            mod_name, _, leaf = name.rpartition(".")
            mod = layer.get_submodule(mod_name) if mod_name else layer
            mod._parameters[leaf] = torch.nn.Parameter(
                sharding.distribute(full, sh))
        x_full = torch.from_numpy(case["x"]).to(device)
        x_sh = sharding.NamedSharding(mesh, sharding.spec_for(
            ("batch", "seq", "embed_act"), x_full.shape, mesh))
        x = sharding.distribute(x_full, x_sh).requires_grad_(True)
        probe = sharding.distribute(torch.from_numpy(case["probe"]).to(
            device), x_sh)
        with sharding.use_rules(mesh), sharding.model_context():
            y = _moe(layer, x, cfg)
            names = [n for n, _ in layer.named_parameters()]
            grads = torch.autograd.grad((y * probe).sum(),
                                        [x] + [p for _, p in
                                               layer.named_parameters()])
        out.append({
            "y": y.full_tensor().detach().cpu().numpy(),
            "grads": {n: g.full_tensor().cpu().numpy() for n, g in
                      zip(["x"] + names, grads)}})
    return out


def _full(x):
    """A DTensor gathered (or a plain tensor) as a float32 numpy array."""
    if sharding.is_dtensor(x):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def train_step_report(cases, device: str) -> list:
    """Each case's train step on this rank's mesh: ``case`` holds
    ``mesh`` ((shape, dim names) over the group's ranks), ``cfg`` (a port
    ``ModelConfig``), ``state`` (the reference's train state as a numpy
    tree: ``convert.train_state_from_numpy``), ``schedule`` (the
    arguments of AdamW's ``cosine_warmup``, without ``keep_master``) and
    ``batch`` (numpy ``inputs`` and ``labels``). The state and the batch
    are laid out by ``train_state_shardings`` and ``batch_shardings``;
    returns per case the ``loss``, the gradients of ``loss_fn`` by
    parameter name, the step's ``metrics``, the parameters after it and
    their ``placements``, gathered, as numpy."""
    import torch

    from .. import convert
    from ..launch.mesh import _init_mesh
    from ..models import ShapeConfig, loss_fn
    from ..optim import AdamW, cosine_warmup
    from . import step as STEP

    out = []
    for case in cases:
        cfg = case["cfg"]
        mesh = _init_mesh(device, *case["mesh"])
        opt = AdamW(learning_rate=cosine_warmup(*case["schedule"]),
                    keep_master=False)
        b, s = case["batch"]["labels"].shape
        with sharding.use_rules(mesh):
            state = STEP.distribute_state(
                convert.train_state_from_numpy(case["state"], cfg, device),
                STEP.train_state_shardings(cfg, opt, mesh))
            b_sh = STEP.batch_shardings(cfg, ShapeConfig("t", s, b, "train"),
                                        mesh)
            batch = {k: sharding.distribute(torch.from_numpy(v).to(device),
                                            b_sh[k])
                     for k, v in case["batch"].items()}
            model = state["params"]
            names, params = zip(*model.named_parameters())
            with sharding.model_context():
                loss = loss_fn(model, cfg, batch)
                grads = torch.autograd.grad(loss, params)
            res = {"loss": float(_full(loss)),
                   "grads": {n: _full(g) for n, g in zip(names, grads)}}
            state, metrics = STEP.make_train_step(cfg, opt)(state, batch)
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["params"] = {n: _full(p) for n, p in
                         state["params"].named_parameters()}
        res["placements"] = {n: tuple(str(pl) for pl in p.placements)
                             for n, p in state["params"].named_parameters()}
        out.append(res)
    return out


def decode_report(cases, device: str) -> list:
    """Each case's decode steps on this rank's mesh: ``case`` holds
    ``mesh``, ``cfg``, ``params`` (the reference's ``init_params`` tree
    as numpy: ``convert.model_params_from_numpy``), ``tokens`` (numpy
    int32 [B, T]) and ``max_len``. The parameters are laid out by
    ``train_state_shardings``, the cache (zeros at position 0) by
    ``cache_shardings``, each step's tokens by ``batch_shardings``; T
    steps of ``make_decode_step``. Returns per case the ``logits`` of
    every step ([T, B, padded vocab], gathered), the cache tensors'
    ``placements`` and their ``local`` position count on this rank."""
    import numpy as np
    import torch

    from .. import convert
    from ..launch.mesh import _init_mesh
    from ..models import ShapeConfig
    from ..optim import AdamW
    from . import step as STEP

    out = []
    for case in cases:
        cfg, max_len = case["cfg"], case["max_len"]
        tokens = torch.from_numpy(case["tokens"]).to(device)
        b, steps = tokens.shape
        mesh = _init_mesh(device, *case["mesh"])
        with sharding.use_rules(mesh):
            p_sh = STEP.train_state_shardings(cfg, AdamW(), mesh)["params"]
            model = STEP.distribute_state(
                {"params": convert.model_params_from_numpy(
                    case["params"], cfg, device)},
                {"params": p_sh})["params"]
            cache = STEP.sharded_tree(
                STEP.cache_shapes(cfg, b, max_len),
                STEP.cache_shardings(cfg, b, max_len, mesh), device,
                torch.zeros)
            cache["pos"] = 0
            in_sh = STEP.batch_shardings(
                cfg, ShapeConfig("d", max_len, b, "decode"), mesh)["inputs"]
            decode = STEP.make_decode_step(cfg)
            logits = []
            for t in range(steps):
                x, cache = decode(model, cache, sharding.distribute(
                    tokens[:, t:t + 1], in_sh))
                logits.append(_full(x)[:, 0])
        first = next(iter(cache["layers"][0].values()))
        out.append({"logits": np.stack(logits),
                    "placements": tuple(str(p) for p in first.placements),
                    "local": first.to_local().shape[1]})
    return out
