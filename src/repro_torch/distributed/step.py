"""Train and decode steps and the train state: the port of
``repro.distributed.step``.

The step is eager (the reference jits it): the loss and every
parameter's gradient (``torch.autograd.grad``), optionally compressed with
error feedback, then the optimizer's update in place. Reductions that the
reference runs over stacked leaves run over groups of the port's
per-layer tensors (``optim.tree``). The state is ``{"params": Model,
"opt": the optimizer's state, ["ef": float32 errors by name]}``; as a
tree of tensors (:func:`checkpoint_tree`) ``checkpoint/store.py`` saves
it, and :func:`train_state_shapes` is the target for restoring it. The
shardings of the reference's GSPMD step (``train_state_shardings``,
``batch_shardings``, ``cache_shardings``, ``logits_sharding``,
``replicated``) wait for the logical-axes trees (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .._device import DEFAULT_DEVICE, DeviceLike
from ..models import ModelConfig, decode_step, init_params, loss_fn
from ..models.model import Model
from ..optim import error_feedback_compress, global_norm, leaf_groups

State = Dict[str, Any]


def make_train_step(cfg: ModelConfig, optimizer, compress_grads: bool = False):
    """state = {"params", "opt", ["ef"]}; returns (state, metrics), the
    state updated in place, metrics ``{"loss", "grad_norm"}`` as 0-dim
    tensors (the norm of the gradients the optimizer gets)."""

    def train_step(state: State, batch: Dict[str, torch.Tensor]):
        model = state["params"]
        names, params = zip(*model.named_parameters())
        loss = loss_fn(model, cfg, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        groups = leaf_groups(model)
        if compress_grads:
            grads, _ = error_feedback_compress(grads, state["ef"], groups)
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads,
                                                                   groups)}
        optimizer.update(grads, state["opt"], model)
        return state, metrics

    return train_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, inputs):
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


def train_state_shapes(cfg: ModelConfig, optimizer,
                       compress_grads: bool = False) -> State:
    """The train state's tree (:func:`checkpoint_tree`'s layout) as
    ``meta`` tensors of the state's shapes and dtypes: a target for
    ``restore_checkpoint``."""
    model = Model(cfg, None, torch.device("meta"))
    shapes = {"params": {n: p.detach() for n, p in model.named_parameters()},
              "opt": optimizer.init(model)}
    if compress_grads:
        shapes["ef"] = _errors(model)
    return shapes


def checkpoint_tree(state: State) -> State:
    """The state as a tree of tensors for ``checkpoint/store.py``: the
    parameters by name. bfloat16 parameters are widened to float32, which
    holds them exactly (numpy has no bfloat16); restoring into
    :func:`train_state_shapes` narrows them back."""
    params = {n: p.detach().float() if p.dtype == torch.bfloat16
              else p.detach() for n, p in state["params"].named_parameters()}
    return {**state, "params": params}


def train_state_from_tree(cfg: ModelConfig, tree: State) -> State:
    """A train state from a restored tree (:func:`checkpoint_tree`'s
    layout): its parameter tensors become the model's, requiring grad."""
    model = Model(cfg, None, torch.device("meta"))
    model.load_state_dict(tree["params"], assign=True)
    return {**tree, "params": model.requires_grad_(True)}
