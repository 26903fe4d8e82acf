"""The decoders of the repo's architecture pool, in PyTorch.

The port of ``repro.models``: configs, parameters, the prefill forward
(attention and MLA through the flash kernel; MoE, SSM) and the cached
decode step, for every layer signature. ``loss_fn`` and ``moe_aux_loss``
(training), the expert-parallel MoE under a mesh and the logical-axes
trees (sharding) wait for later slices of the port.
"""
from .config import ModelConfig, ShapeConfig, SHAPES, reduced
from .model import (Model, init_params, forward, init_cache, decode_step,
                    build_plan, layer_sigs)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "reduced", "Model",
    "init_params", "forward", "init_cache", "decode_step", "build_plan",
    "layer_sigs",
]
