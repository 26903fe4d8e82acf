"""The optimizers' view of a parameter tree: leaves by name, grouped into
the reference's leaves.

The port's optimizers take what the reference's take, a tree of
parameters, as a model (``nn.Module``: its named parameters) or a dict of
tensors (nested dicts flattened to dotted names). Their state keeps one
tensor per parameter under the parameter's name.

The reference stacks the layers of each block into leaves of shape
``[repeat, ...]`` (``blocks[b][slot][name]``); the port keeps one tensor
per layer. A reduction the reference runs over a whole leaf (Adafactor's
update clipping, the int8 scale of gradient compression, the global norm)
therefore spans every layer of that block and slot, and the port runs it
over the :class:`Group` of its per-layer tensors that form the leaf, so
that both compute the same update. Groups come in the reference's leaf
order (``jax.tree.leaves``: dict keys sorted, list positions in order).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import torch
from torch import nn

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Group:
    """One reference leaf: its path in the reference's tree (list
    positions as ints, dict keys as strings), the port's names that form
    it, in repeat order, and whether it is a block's stacked leaf (then its
    shape is ``(len(names),) + the layer's``)."""
    path: Tuple[Union[str, int], ...]
    names: Tuple[str, ...]
    stacked: bool

    def shape(self, leaves: Leaves) -> Tuple[int, ...]:
        """The reference leaf's shape."""
        one = tuple(leaves[self.names[0]].shape)
        return (len(self.names),) + one if self.stacked else one


def _flatten(tree, prefix: str, out: Leaves) -> Leaves:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


def named_leaves(params) -> Leaves:
    """``{name: tensor}``: a module's named parameters, or a dict tree's
    leaves under their dotted paths."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return _flatten(params, "", {})


def leaf_groups(params) -> List[Group]:
    """The reference's leaves as groups of the port's, in the reference's
    leaf order. A model's layer ``i`` is repeat ``r``, slot ``si`` of block
    ``b`` in the order of ``build_plan`` (block by block, repeat-major), so
    its parameter ``layers.i.<rest>`` joins the group of path ``("blocks",
    b, si, *rest)``; every other leaf is a group of its own."""
    slots = {}
    cfg = getattr(params, "cfg", None)
    if isinstance(params, nn.Module) and cfg is not None:
        from ..models.model import build_plan

        i = 0
        for b, blk in enumerate(build_plan(cfg)):
            for _ in range(blk.repeat):
                for si in range(len(blk.sigs)):
                    slots[str(i)] = ("blocks", b, si)
                    i += 1
    found: Dict[tuple, List[str]] = {}
    stacked = set()
    for name in named_leaves(params):
        parts = tuple(name.split("."))
        if parts[0] == "layers" and parts[1] in slots:
            parts = slots[parts[1]] + parts[2:]
            stacked.add(parts)
        found.setdefault(parts, []).append(name)
    return [Group(path, tuple(names), path in stacked)
            for path, names in sorted(found.items())]
