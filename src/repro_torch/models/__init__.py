"""The dense decoder of the repo's architecture pool, in PyTorch.

The port of ``repro.models`` for layers of signature ("attn", "mlp"):
configs, parameters, the prefill forward (attention through the flash
kernel) and the cached decode step. ``loss_fn`` (training) and the
logical-axes trees (sharding) wait for later slices of the port.
"""
from .config import ModelConfig, ShapeConfig, SHAPES, reduced
from .model import (Model, init_params, forward, init_cache, decode_step,
                    build_plan, layer_sigs)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "reduced", "Model",
    "init_params", "forward", "init_cache", "decode_step", "build_plan",
    "layer_sigs",
]
