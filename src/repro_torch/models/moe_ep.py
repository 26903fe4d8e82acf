"""The MoE layer over a mesh: expert parallel (``moe_fwd_ep``) and the
sharded form of ``moe_fwd``.

The port of ``repro.models.moe_ep``. Activations are batch-sharded only
("batch" over the data dims, replicated over "model"), so every "model"
rank already holds its data shard's tokens and expert dispatch moves no
token: each rank routes its local tokens, keeps the assignments to its
E/ep experts (experts split over "model"), runs those experts, adds the
ff-split shared expert's partial, and one all-reduce over "model" sums the
partials. The expert weights rest ZeRO-3 sharded (expert over "model", d
over "data") and are all-gathered over "data" for the layer. Capacity is
per data shard, C_loc = max(1, ceil(t_loc·k/E·cf)), so drops are decided
locally (it differs from ``moe_fwd`` under skew, as the reference's does).

The rank's part runs on local tensors inside ``local_map``: routing keeps
the port's stable sort and ranks (:func:`.layers.moe_route`), the experts
are :func:`.layers.moe_experts` over this rank's range. The all-reduce is
the DTensor redistribute of the block's ``Partial`` output. Without a mesh
with a "model" dim that divides E, ``moe_fwd_ep`` is ``moe_fwd``.

:func:`moe_fwd_sharded` is ``moe_fwd`` (``moe_impl="gspmd"``) on
DTensors: the same block over all tokens of the batch (gathered over the
data dims), with the capacity over them all, as the reference's GSPMD
program computes it; the shared expert runs as the batch-sharded MLP.
"""
from __future__ import annotations

import math

import torch

from ..distributed import sharding as SH
from .config import ModelConfig
from .layers import MoE, _act, mlp_fwd, moe_experts, moe_fwd, moe_route

_DP = ("pod", "data")


def _block(cfg: ModelConfig, mesh, x, p: MoE, *, local_tokens: bool,
           shared: bool):
    """The per-rank MoE on DTensors: x [B, S, d] batch-sharded over the
    data dims when ``local_tokens`` (else replicated); returns y [B, S, d]
    with x's data-dim placements, replicated over "model" after the one
    all-reduce of the partials."""
    from torch.distributed.tensor import Partial, Replicate

    sizes = SH.axis_sizes(mesh)
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    msize = sizes.get("model", 1)
    model = [mesh.mesh_dim_names.index("model")] if "model" in sizes else []
    batch = SH.spec_axes(SH.spec_for(("batch",), (x.shape[0],), mesh)[0])
    x_pl = SH.layout(mesh, shard0=[mesh.mesh_dim_names.index(n)
                                   for n in batch] if local_tokens else [])
    by_expert = bool(model) and e % msize == 0
    by_ff = bool(model) and not by_expert and cfg.moe_d_ff % msize == 0
    split = by_expert or by_ff
    wi_pl = SH.layout(mesh, **({"shard0": model} if by_expert else
                               {"shard2": model} if by_ff else {}))
    wo_pl = SH.layout(mesh, **({"shard0": model} if by_expert else
                               {"shard1": model} if by_ff else {}))
    args = [x, p.router, p.wi_gate, p.wi_up, p.wo]
    in_pl = [x_pl, SH.layout(mesh), wi_pl, wi_pl, wo_pl]
    if shared:
        args += [p.shared.wi_gate, p.shared.wi_up, p.shared.wo]
        in_pl += [SH.layout(mesh, shard1=model),
                  SH.layout(mesh, shard1=model),
                  SH.layout(mesh, shard0=model)]
    out_pl = SH.partial_over(x_pl, model if (split or shared) else [])
    first = (mesh.get_local_rank("model") * (e // msize) if by_expert
             else 0)

    def local(xl, router, wg, wu, wo, *sh):
        bl, sl, d = xl.shape
        t = bl * sl
        cap = max(1, int(math.ceil(t * k / e * cfg.capacity_factor)))
        xt = xl.reshape(t, d)
        r = moe_route(None, xt, cfg, cap=cap, router=router)
        y = moe_experts(xt, r, wg, wu, wo, cfg, first=first).to(xl.dtype)
        if sh:
            sg, su, swo = sh
            y = y + (_act(cfg)(xt @ sg) * (xt @ su)) @ swo
        return y.reshape(bl, sl, d)

    # the gradients: a rank's part is partial over "model" (its experts
    # or ff slice) wherever an input is replicated there, and, with local
    # tokens, over the data dims (its tokens); with all tokens the data
    # ranks compute alike, so their copies agree
    varies = [n == "model" and (split or shared) or (n in _DP and
                                                     local_tokens)
              for n in mesh.mesh_dim_names]
    grad_pl = [[Partial() if (v and isinstance(pl, Replicate)) else pl
                for v, pl in zip(varies, pls)] for pls in in_pl]
    y = SH.run_local(local, mesh, args, in_pl, out_pl, grad_pl)
    return y.redistribute(mesh, [Replicate() if n == "model" else pl
                                 for n, pl in zip(mesh.mesh_dim_names,
                                                  y.placements)])


def moe_fwd_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Expert-parallel MoE when a mesh with a "model" dim that divides the
    expert count is active (x a DTensor); ``moe_fwd`` otherwise."""
    mesh = SH.active_mesh()
    if mesh is None or not SH.is_dtensor(x):
        return moe_fwd(p, x, cfg)
    sizes = SH.axis_sizes(x.device_mesh)
    if "model" not in sizes or cfg.moe_num_experts % sizes["model"]:
        return moe_fwd(p, x, cfg)
    return _block(cfg, x.device_mesh, x, p, local_tokens=True,
                  shared=bool(cfg.moe_shared_experts))


def moe_fwd_sharded(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """``moe_fwd`` on a DTensor x: the routed experts over all B·S tokens
    (gathered over the data dims, capacity over them all), split over
    "model" by expert (or by ff when the experts do not divide), the
    result back on x's batch shards; plus the batch-sharded shared
    expert."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    xg = SH.replicated_over(x, *_DP)
    y = _block(cfg, mesh, xg, p, local_tokens=False, shared=False)
    y = y.redistribute(mesh, [pl if isinstance(pl, Shard) else Replicate()
                              for pl in x.placements])
    if cfg.moe_shared_experts:
        y = y + mlp_fwd(p.shared, x, cfg)
    return y
