"""Stand-in inputs for every (arch × shape) cell: the port of
``repro.launch.specs``.

``input_specs(cfg, shape)`` returns the train batch (or the decode
step's input) as ``meta`` tensors of the reference's shapes and dtypes:
no allocation. Modality frontends are stubs: embeddings-mode archs get
precomputed [B, S, d_model] activations.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models import ModelConfig, ShapeConfig
from ..models.layers import _dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len

    def t(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":
        inputs = (t((b, 1), torch.int32) if cfg.input_mode == "tokens"
                  else t((b, 1, cfg.d_model), _dtype(cfg)))
        return {"inputs": inputs}
    inputs = (t((b, s), torch.int32) if cfg.input_mode == "tokens"
              else t((b, s, cfg.d_model), _dtype(cfg)))
    batch = {"inputs": inputs, "labels": t((b, s), torch.int32)}
    if cfg.rope_kind == "mrope":
        batch["positions"] = t((b, s, 3), torch.int32)
    return batch
