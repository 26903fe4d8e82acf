"""Optimizers, schedules and gradient compression: the port of
``repro.optim``.

Each optimizer keeps the reference's functional surface, ``init(params)
-> state`` and ``update(grads, state, params) -> (params, state)``, over a
model or a dict of tensors (:mod:`.tree`); inside, it updates the
parameters and its state in place under ``torch.no_grad()``. Reductions
that the reference runs over a stacked leaf run over the port's group of
per-layer tensors (:func:`.tree.leaf_groups`), so the updates are the
reference's.
"""
from .adafactor import Adafactor
from .adamw import AdamW, clip_by_global_norm, global_norm
from .compress import (dequantize_int8, error_feedback_compress,
                       quantize_int8)
from .schedule import cosine_warmup
from .tree import Group, leaf_groups, named_leaves

__all__ = ["AdamW", "Adafactor", "Group", "clip_by_global_norm",
           "cosine_warmup", "dequantize_int8", "error_feedback_compress",
           "global_norm", "leaf_groups", "named_leaves", "quantize_int8"]
