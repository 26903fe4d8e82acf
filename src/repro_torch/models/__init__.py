"""The decoders of the repo's architecture pool, in PyTorch.

The port of ``repro.models``: configs, parameters, the prefill forward
(attention and MLA through the flash kernel, which has a gradient; MoE,
SSM), the train loss (``loss_fn``; ``layers.moe_aux_loss`` beside it)
with per-layer remat, and the cached decode step, for every layer
signature; the logical-axes trees of the parameters and the cache
(``params_logical_axes``, ``cache_logical_axes``) that lay them out over
a mesh, where the model runs on DTensors (the MoE expert parallel with
``moe_impl="ep"``, ``moe_ep``).
"""
from .config import ModelConfig, ShapeConfig, SHAPES, reduced
from .layers import moe_aux_loss
from .model import (Model, init_params, forward, loss_fn, init_cache,
                    decode_step, build_plan, layer_sigs, params_logical_axes,
                    cache_logical_axes)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "reduced", "Model",
    "init_params", "forward", "loss_fn", "moe_aux_loss", "init_cache",
    "decode_step", "build_plan", "layer_sigs", "params_logical_axes",
    "cache_logical_axes",
]
