"""AdamW with optional float32 master weights, and the global-norm clip:
the port of ``repro.optim.adamw``.

The state mirrors the parameters by name (``mu``, ``nu``, and ``master``
when ``keep_master``) and counts ``step`` in a 0-dim int32 tensor; it is a
tree of tensors that ``checkpoint/store.py`` saves and restores. The
update runs leaf by leaf in float32, in the reference's order of
operations: the clipped gradient is rounded back to its own dtype, as the
reference's ``clip_by_global_norm`` returns it, and the new parameter is
rounded to the parameter's dtype. The learning rate and the bias
corrections are float32 numbers of the step count.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Union

import torch

from .tree import Group, Leaves, leaf_groups, named_leaves


def learning_rate_at(learning_rate, step: int) -> float:
    """The float32 learning rate at ``step``: a schedule's value (it gets
    the step as an int32 tensor) or the constant, rounded to float32."""
    with host_numbers():
        return _learning_rate_at(learning_rate, step)


def _learning_rate_at(learning_rate, step: int) -> float:
    if callable(learning_rate):
        lr = learning_rate(torch.tensor(step, dtype=torch.int32))
    else:
        lr = torch.tensor(learning_rate, dtype=torch.float32)
    return float(lr.to(torch.float32))


def host_numbers():
    """A context in which the step count and the learning rate are host
    numbers: outside any ``FakeTensorMode`` (the dry run traces the step
    with fake tensors, but its step counter and schedule are real)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()


def step_count(state) -> int:
    """The state's step counter as an int."""
    with host_numbers():
        return int(state["step"])


def set_step(state, step: int) -> None:
    with host_numbers():
        state["step"].fill_(step)


def f32(x) -> torch.Tensor:
    """``x`` as a float32 0-dim tensor on the host."""
    return torch.tensor(x, dtype=torch.float32)


def step_state(params) -> torch.Tensor:
    """A 0-dim int32 step counter on the parameters' device (a real
    tensor, also under a ``FakeTensorMode``)."""
    leaves = list(named_leaves(params).values())
    dev = leaves[0].device if leaves else torch.device("cpu")
    with host_numbers():
        return torch.zeros((), dtype=torch.int32, device=dev)


def _square_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ t² in float32 (a 0-dim tensor), without a float32 copy of t."""
    return torch.linalg.vector_norm(t, dtype=torch.float32).square()


def global_norm(tree, groups: Optional[List[Group]] = None) -> torch.Tensor:
    """sqrt(Σ g²) over every leaf of ``tree`` (a dict of tensors by name)
    in float32: each group's sum (``groups``, by default each leaf alone),
    added in the groups' order, as the reference adds its leaves' sums."""
    leaves = named_leaves(tree)
    total = torch.zeros((), dtype=torch.float32)
    for grp in groups if groups is not None else leaf_groups(tree):
        part = None
        for name in grp.names:
            s = _square_sum(leaves[name])
            part = s if part is None else part + s
        total = total.to(part.device) + part
    return torch.sqrt(total)


def clip_scale(tree, max_norm: float,
               groups: Optional[List[Group]] = None) -> Optional[torch.Tensor]:
    """The factor ``min(1, max_norm / max(norm, 1e-12))`` (float32), None
    when ``max_norm`` is 0 (no clipping)."""
    if not max_norm:
        return None
    norm = global_norm(tree, groups)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float,
                        groups: Optional[List[Group]] = None) -> Leaves:
    """A new dict of the leaves scaled by :func:`clip_scale` in float32 and
    rounded back to their dtypes (``tree`` itself when ``max_norm`` is 0)."""
    scale = clip_scale(tree, max_norm, groups)
    if scale is None:
        return tree
    return {name: (g.float() * scale).to(g.dtype)
            for name, g in named_leaves(tree).items()}


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    keep_master: bool = True   # float32 master copy when params are bf16

    def init(self, params):
        leaves = named_leaves(params)
        state = {"mu": {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in leaves.items()},
                 "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in leaves.items()},
                 "step": step_state(params)}
        if self.keep_master:
            state["master"] = {n: p.detach().to(torch.float32, copy=True)
                               for n, p in leaves.items()}
        return state

    def state_logical_axes(self, params_axes, params_shapes=None):
        """The state's logical axes: each moment (and master copy) has its
        parameter's axes, keyed by the parameter's name; ``step`` ()."""
        del params_shapes
        ax = {"mu": dict(params_axes), "nu": dict(params_axes), "step": ()}
        if self.keep_master:
            ax["master"] = dict(params_axes)
        return ax

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: ``params`` and ``state`` updated in place and
        returned. ``grads`` maps each parameter's name to its gradient; it
        is read, not changed."""
        leaves = named_leaves(params)
        step = step_count(state) + 1
        lr = learning_rate_at(self.learning_rate, step)
        scale = clip_scale(grads, self.grad_clip, leaf_groups(params))
        b1, b2 = self.b1, self.b2
        with host_numbers():
            c1 = float(1.0 - f32(b1) ** f32(step))
            c2 = float(1.0 - f32(b2) ** f32(step))
        for name, p in leaves.items():
            g = grads[name]
            g32 = g.float() if scale is None else \
                (g.float() * scale).to(g.dtype).float()
            mu, nu = state["mu"][name], state["nu"][name]
            mu.mul_(b1).add_(g32, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            del g32
            base = state["master"][name] if self.keep_master else p.float()
            upd = (mu / c1).div_((nu / c2).sqrt_().add_(self.eps))
            upd.add_(base, alpha=self.weight_decay)
            new = base - upd.mul_(lr)
            del upd
            if self.keep_master:
                base.copy_(new)
            p.copy_(new)
        set_step(state, step)
        return params, state
