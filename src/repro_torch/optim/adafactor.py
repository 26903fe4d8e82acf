"""Adafactor (factored second moments, no momentum): the port of
``repro.optim.adafactor``.

The second moment of a leaf whose last two dims are both at least
``min_dim_size_to_factor`` is kept as row and column factors ``vr``,
``vc``; others keep a full ``v``. The rule reads the reference leaf's
shape, so a layer's tensor is factored as its block's stacked leaf is.
The update clipping's RMS spans the whole reference leaf: the group of
per-layer tensors of one block and slot (:mod:`.tree`). Each group is
visited twice, first to update the moments and sum the squared
preconditioned gradient, then to apply it; the second visit recomputes
it from the updated moments rather than keeping a float32 copy of the
stacked leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch

from .adamw import (f32, host_numbers, learning_rate_at, set_step,
                    step_count, step_state)
from .tree import leaf_groups, named_leaves


@dataclasses.dataclass(frozen=True)
class Adafactor:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-2
    decay: float = 0.8          # t^-decay second-moment decay schedule
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128

    def _factored(self, shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= self.min_dim_size_to_factor
                and shape[-2] >= self.min_dim_size_to_factor)

    def init(self, params):
        leaves = named_leaves(params)
        v = {}
        for grp in leaf_groups(params):
            factored = self._factored(grp.shape(leaves))
            for name in grp.names:
                p = leaves[name]
                if factored and p.dim() < 2:
                    raise NotImplementedError(
                        f"{grp.path}: a block of {len(grp.names)} repeats "
                        f"factors its 1-D leaf {name} across layers; the "
                        "port keeps per-layer moments")
                zeros = dict(dtype=torch.float32, device=p.device)
                v[name] = ({"vr": torch.zeros(p.shape[:-1], **zeros),
                            "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                              **zeros)}
                           if factored else
                           {"v": torch.zeros(p.shape, **zeros)})
        return {"v": v, "step": step_state(params)}

    def state_logical_axes(self, params_axes, params_shapes):
        """The state's logical axes by parameter name: ``vr`` the
        parameter's without its last axis, ``vc`` without its second last,
        where the reference leaf's shape (``params_shapes``: a model or a
        dict of tensors, grouped as :func:`.tree.leaf_groups`) is
        factored; else ``v`` with the parameter's axes; ``step`` ()."""
        leaves = named_leaves(params_shapes)
        out = {}
        for grp in leaf_groups(params_shapes):
            factored = self._factored(grp.shape(leaves))
            for name in grp.names:
                ax = tuple(params_axes[name])
                out[name] = ({"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
                             if factored else {"v": ax})
        return {"v": out, "step": ()}

    def _precond(self, g: torch.Tensor, v) -> torch.Tensor:
        """The float32 gradient ``g`` over the second moment ``v``."""
        if "vr" in v:
            vr = v["vr"]
            mean_vr = torch.clamp(vr.mean(dim=-1, keepdim=True),
                                  min=self.eps)
            denom = ((vr / mean_vr).sqrt_()[..., None]
                     * v["vc"].sqrt()[..., None, :]).add_(self.eps)
            return g / denom
        return g * torch.rsqrt(v["v"] + self.eps)

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: ``params`` and ``state`` updated in place and
        returned. ``grads`` maps each parameter's name to its gradient; it
        is read, not changed."""
        leaves = named_leaves(params)
        step = step_count(state) + 1
        lr = learning_rate_at(self.learning_rate, step)
        with host_numbers():
            beta2_t = 1.0 - f32(step) ** (-self.decay)
            beta2, rest = float(beta2_t), float(1.0 - beta2_t)
        for grp in leaf_groups(params):
            sq = None
            for name in grp.names:
                g = grads[name].float()
                g2 = g.square().add_(self.eps)
                v = state["v"][name]
                if "vr" in v:
                    v["vr"].mul_(beta2).add_(g2.mean(dim=-1), alpha=rest)
                    v["vc"].mul_(beta2).add_(g2.mean(dim=-2), alpha=rest)
                else:
                    v["v"].mul_(beta2).add_(g2, alpha=rest)
                del g2
                s = self._precond(g, v).square().sum()
                sq = s if sq is None else sq + s
            n = math.prod(grp.shape(leaves))
            div = torch.clamp(torch.sqrt(sq / n + 1e-30)
                              / self.clip_threshold, min=1.0)
            for name in grp.names:
                p = leaves[name]
                pre = self._precond(grads[name].float(),
                                    state["v"][name]).div_(div)
                p32 = p.float()
                p.copy_(p32 - pre.add_(p32, alpha=self.weight_decay)
                        .mul_(lr))
        set_step(state, step)
        return params, state
