"""Gradient compression with error feedback: the port of
``repro.optim.compress``.

int8 uniform quantization with a persistent error-feedback accumulator:
the quantization residual is carried to the next step, so the compressed
update is unbiased over time (Seide et al. / EF-SGD). The int8 scale of
a reference leaf is its max |value|, so the port takes it over the group
of per-layer tensors that form the leaf (:mod:`.tree`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .tree import Group, Leaves, leaf_groups, named_leaves


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and their float32 scale (by default
    ``max|x| / 127 + 1e-12``)."""
    if scale is None:
        scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def error_feedback_compress(grads, err_state: Optional[Leaves] = None,
                            groups: Optional[List[Group]] = None):
    """Returns (decompressed grads, error state). ``grads`` maps names to
    gradients; ``err_state`` maps them to float32 errors (None starts from
    zeros) and is updated in place. ``groups`` (default: each gradient
    alone) share one scale each."""
    grads = named_leaves(grads)
    if err_state is None:
        err_state = {n: torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device)
                     for n, g in grads.items()}
    out = {}
    for grp in groups if groups is not None else leaf_groups(grads):
        top = torch.stack([(grads[n].float() + err_state[n]).abs().max()
                           for n in grp.names]).max()
        scale = top / 127.0 + 1e-12
        for name in grp.names:
            g, e = grads[name], err_state[name]
            corrected = g.float() + e
            q, _ = quantize_int8(corrected, scale)
            deq = dequantize_int8(q, scale)
            out[name] = deq.to(g.dtype)
            e.copy_(corrected.sub_(deq))
    return out, err_state
