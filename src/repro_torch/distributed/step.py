"""Train and decode steps and the train state: the port of
``repro.distributed.step``.

The step is eager (the reference jits it): the loss and every
parameter's gradient (``torch.autograd.grad``), optionally compressed with
error feedback, then the optimizer's update in place. Reductions that the
reference runs over stacked leaves run over groups of the port's
per-layer tensors (``optim.tree``). The state is ``{"params": Model,
"opt": the optimizer's state, ["ef": float32 errors by name]}``; as a
tree of tensors (:func:`checkpoint_tree`) ``checkpoint/store.py`` saves
it, and :func:`train_state_shapes` is the target for restoring it.

Shardings: the reference jits its step with ``in_shardings`` built from
the logical-axes trees. The port builds the same trees of
``sharding.NamedSharding`` (:func:`train_state_shardings`,
:func:`batch_shardings`, :func:`cache_shardings`,
:func:`logits_sharding`, :func:`replicated`) over ``meta`` shapes, lays a
state out by them as DTensors (:func:`distribute_state`, or
:func:`init_sharded_train_state` for a state too large to exist whole on
one rank), and runs the step on DTensors under ``use_rules(mesh)``, where
the model's ``shard_as`` points constrain activations.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..models import (ModelConfig, ShapeConfig, cache_logical_axes,
                      decode_step, init_cache, init_params, loss_fn,
                      params_logical_axes)
from ..models.model import Model
from ..optim import error_feedback_compress, global_norm, leaf_groups
from . import sharding as SH

State = Dict[str, Any]


def make_train_step(cfg: ModelConfig, optimizer, compress_grads: bool = False):
    """state = {"params", "opt", ["ef"]}; returns (state, metrics), the
    state updated in place, metrics ``{"loss", "grad_norm"}`` as 0-dim
    tensors (the norm of the gradients the optimizer gets)."""

    def train_step(state: State, batch: Dict[str, torch.Tensor]):
        with SH.model_context():
            return _train_step(state, batch)

    def _train_step(state: State, batch: Dict[str, torch.Tensor]):
        model = state["params"]
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, cfg, batch)
        grads = {n: _laid_out_as(g, p) for n, g, p in
                 zip(names, torch.autograd.grad(loss, params), params)}
        groups = leaf_groups(model)
        if compress_grads:
            grads, _ = error_feedback_compress(grads, state["ef"], groups)
        metrics = {"loss": _whole(loss.detach()),
                   "grad_norm": _whole(global_norm(grads, groups))}
        optimizer.update(grads, state["opt"], model)
        return state, metrics

    return train_step


def _laid_out_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's layout (partial sums over the
    ranks reduced: the step's data-parallel all-reduce or reduce-scatter);
    a plain gradient as it is."""
    if SH.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor metric as a plain tensor (every rank's copy of the
    reduced value); a plain one as it is."""
    return x.full_tensor() if SH.is_dtensor(x) else x


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, inputs):
        with torch.no_grad(), SH.model_context():
            return decode_step(params, cache, cfg, inputs)
    return serve_step


def _errors(model: Model) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in model.named_parameters()}


def init_train_state(cfg: ModelConfig, optimizer, key=0,
                     compress_grads: bool = False,
                     device: DeviceLike = DEFAULT_DEVICE) -> State:
    """Fresh weights (``init_params(cfg, key)``, requiring grad), the
    optimizer's initial state and, when compressing, zero errors."""
    params = init_params(cfg, key, device=device).requires_grad_(True)
    state = {"params": params, "opt": optimizer.init(params)}
    if compress_grads:
        state["ef"] = _errors(params)
    return state


def _meta_model(cfg: ModelConfig) -> Model:
    return Model(cfg, None, torch.device("meta"))


def param_shapes(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor, by name."""
    return {n: p.detach() for n, p in _meta_model(cfg).named_parameters()}


def train_state_shapes(cfg: ModelConfig, optimizer,
                       compress_grads: bool = False) -> State:
    """The train state's tree (:func:`checkpoint_tree`'s layout) as
    ``meta`` tensors of the state's shapes and dtypes: a target for
    ``restore_checkpoint``."""
    model = _meta_model(cfg)
    shapes = {"params": {n: p.detach() for n, p in model.named_parameters()},
              "opt": optimizer.init(model)}
    if compress_grads:
        shapes["ef"] = _errors(model)
    return shapes


def checkpoint_tree(state: State) -> State:
    """The state as a tree of tensors for ``checkpoint/store.py``: the
    parameters by name. bfloat16 parameters are widened to float32, which
    holds them exactly (numpy has no bfloat16); restoring into
    :func:`train_state_shapes` narrows them back. DTensors are gathered
    whole (a collective: every rank of the mesh calls this)."""
    def whole(t):
        t = t.detach()
        t = t.full_tensor() if SH.is_dtensor(t) else t
        return t.float() if t.dtype == torch.bfloat16 else t

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return whole(tree) if isinstance(tree, torch.Tensor) else tree

    params = {n: whole(p) for n, p in state["params"].named_parameters()}
    return {**{k: walk(v) for k, v in state.items() if k != "params"},
            "params": params}


def restore_shardings(shardings, target):
    """``shardings`` for ``restore_checkpoint`` into ``target``
    (:func:`train_state_shapes`): None for 0-dim leaves, which stay plain
    host counters as :func:`distribute_state` leaves them."""
    if isinstance(target, torch.Tensor):
        return None if target.dim() == 0 else shardings
    if isinstance(target, dict):
        return {k: restore_shardings(shardings[k], v)
                for k, v in target.items()}
    return shardings


def train_state_from_tree(cfg: ModelConfig, tree: State) -> State:
    """A train state from a restored tree (:func:`checkpoint_tree`'s
    layout): its parameter tensors become the model's, requiring grad."""
    model = Model(cfg, None, torch.device("meta"))
    model.load_state_dict(tree["params"], assign=True)
    return {**tree, "params": model.requires_grad_(True)}


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def train_state_shardings(cfg: ModelConfig, optimizer, mesh,
                          overrides=None, compress_grads: bool = False):
    """The train state's :class:`~.sharding.NamedSharding` tree, in
    :func:`train_state_shapes`' layout: parameters by their logical axes,
    the optimizer's state by ``optimizer.state_logical_axes``, the
    compression errors as the parameters."""
    model = _meta_model(cfg)
    p_axes = params_logical_axes(cfg)
    shard = {"params": SH.sharding_for_tree(
        p_axes, dict(model.named_parameters()), mesh, overrides)}
    opt_axes = optimizer.state_logical_axes(p_axes, model)
    shard["opt"] = SH.sharding_for_tree(opt_axes, optimizer.init(model), mesh,
                                        overrides)
    if compress_grads:
        shard["ef"] = shard["params"]
    return shard


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    overrides=None) -> Dict[str, SH.NamedSharding]:
    """The train batch's shardings: tokens (or embeddings) and labels over
    ("batch", "seq"), M-RoPE positions over ("batch", "seq", None)."""
    with SH.use_rules(mesh, overrides):
        tok = SH.spec_for(("batch", "seq"),
                          (shape.global_batch, shape.seq_len), mesh)
        out = {"inputs": SH.NamedSharding(mesh, tok),
               "labels": SH.NamedSharding(mesh, tok)}
        if cfg.input_mode == "embeddings":
            emb = SH.spec_for(("batch", "seq", "embed_act"),
                              (shape.global_batch, shape.seq_len,
                               cfg.d_model), mesh)
            out["inputs"] = SH.NamedSharding(mesh, emb)
        if cfg.rope_kind == "mrope":
            pos = SH.spec_for(("batch", "seq", None),
                              (shape.global_batch, shape.seq_len, 3), mesh)
            out["positions"] = SH.NamedSharding(mesh, pos)
    return out


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The decode cache (:func:`init_cache`'s layout) as ``meta`` tensors,
    its position a 0-dim int32."""
    cache = init_cache(cfg, batch, max_len, device="meta")
    return {**cache, "pos": torch.zeros((), dtype=torch.int32,
                                        device="meta")}


def cache_shardings(cfg: ModelConfig, batch: int, max_len: int, mesh,
                    overrides=None):
    """The decode cache's shardings by its logical axes."""
    return SH.sharding_for_tree(cache_logical_axes(cfg),
                                cache_shapes(cfg, batch, max_len), mesh,
                                overrides)


def logits_sharding(cfg: ModelConfig, mesh, batch: int, seq: int,
                    overrides=None) -> SH.NamedSharding:
    """The logits' sharding: ("batch", None, "vocab")."""
    with SH.use_rules(mesh, overrides):
        spec = SH.spec_for(("batch", None, "vocab"),
                           (batch, seq, cfg.padded_vocab), mesh)
    return SH.NamedSharding(mesh, spec)


def replicated(mesh) -> SH.NamedSharding:
    return SH.NamedSharding(mesh, ())


def _set_params(model: nn.Module, make) -> nn.Module:
    """Replace each parameter ``p`` named ``name`` by ``make(name, p)``
    (a tensor), keeping whether it requires grad."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(make(name, p.detach()),
                                             requires_grad=p.requires_grad)
    return model


def _distribute_tree(tree, shardings):
    if isinstance(tree, torch.Tensor):
        if shardings is None or tree.dim() == 0:
            return tree
        return SH.distribute(tree, shardings)
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, shardings[k]) for k, v in tree.items()}
    return tree


def distribute_state(state: State, shardings) -> State:
    """The state laid out by ``shardings`` (:func:`train_state_shardings`)
    as DTensors, each rank keeping its shards of tensors it holds whole
    (no communication): the counterpart of jit's ``in_shardings``. The
    model's parameters are replaced in place; 0-dim tensors (the step
    counter) stay plain host counters."""
    out = dict(state)
    psh = shardings["params"]
    out["params"] = _set_params(state["params"],
                                lambda n, p: SH.distribute(p, psh[n]))
    for key in state:
        if key != "params":
            out[key] = _distribute_tree(state[key], shardings[key])
    return out


def sharded_tensor(sh: SH.NamedSharding, global_shape, dtype, device,
                   fill=None):
    """A DTensor of ``global_shape`` laid out by ``sh`` whose local shard
    this rank makes alone: ``fill(shape, dtype, device)`` (uninitialised
    memory by default)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    with unset_fake_temporarily():  # the mesh's coordinates are real
        shape, _ = compute_local_shape_and_global_offset(
            tuple(global_shape), sh.mesh, sh.placements)
    local = (fill or torch.empty)(shape, dtype=dtype, device=device)
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(global_shape),
                              stride=torch.empty(global_shape,
                                                 device="meta").stride())


def sharded_tree(shapes, shardings, device, fill=None):
    """:func:`sharded_tensor` for every tensor of a tree of (``meta``)
    tensors and its matching tree of shardings; 0-dim tensors become
    plain zeros (host counters such as a step or a position)."""
    if isinstance(shapes, torch.Tensor):
        if shapes.dim() == 0:      # real, also under a FakeTensorMode
            from torch._subclasses.fake_tensor import unset_fake_temporarily

            with unset_fake_temporarily():
                return torch.zeros((), dtype=shapes.dtype)
        return sharded_tensor(shardings, shapes.shape, shapes.dtype, device,
                              fill)
    if isinstance(shapes, dict):
        return {k: sharded_tree(v, shardings[k], device, fill)
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [sharded_tree(v, sh, device, fill)
                for v, sh in zip(shapes, shardings)]
    return shapes


def init_sharded_params(cfg: ModelConfig, shardings,
                        seed: Optional[int] = 0,
                        device: DeviceLike = DEFAULT_DEVICE) -> Model:
    """A model made shard by shard on this rank, never whole: parameters
    as DTensors laid out by ``shardings`` (:func:`train_state_shardings`'
    ``"params"``), N(0, 0.02²) from ``seed`` (floating types; not
    :func:`init_params`' values) or uninitialised when ``seed`` is None
    (the dry run's fake tensors)."""
    dev = resolve_device(device)
    fill = None
    if seed is not None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def fill(shape, dtype, device):
            return torch.randn(shape, generator=gen, device=device).mul_(
                0.02).to(dtype)

    return _set_params(_meta_model(cfg), lambda n, p: sharded_tensor(
        shardings[n], p.shape, p.dtype, dev, fill))


def init_sharded_train_state(cfg: ModelConfig, optimizer, shardings,
                             seed: Optional[int] = 0,
                             device: DeviceLike = DEFAULT_DEVICE) -> State:
    """:func:`init_sharded_params` requiring grad, and the optimizer's
    initial state laid out by ``shardings["opt"]``: a train state too
    large to exist whole on one rank."""
    model = init_sharded_params(cfg, shardings["params"], seed, device)
    model.requires_grad_(True)
    opt = sharded_tree(optimizer.init(_meta_model(cfg)), shardings["opt"],
                       resolve_device(device), torch.zeros)
    if "master" in opt:             # AdamW's float32 copy of the weights
        with torch.no_grad():
            for name, p in model.named_parameters():
                opt["master"][name].copy_(p)
    return {"params": model, "opt": opt}
