"""Checkpointing with atomic publish, async writes and restore onto a device.

Layout (the reference's, so either package reads the other's checkpoints):
         <dir>/step_<N:08d>/   one "<key>.npy" per leaf + meta.json
         <dir>/step_<N>.tmp.<pid> during a write (renamed on success)

A key joins the leaf's path with ``__``: a dict key as itself, a list or
tuple position ``i`` as ``idx<i>``. Dict keys are walked in sorted order
and ``None`` holds no leaf, as ``jax.tree_util`` walks a tree, so the
leaves and ``meta.json`` (``{"step", "leaves": {key: {"shape",
"dtype"}}}``) are the reference's byte for byte. Leaves may be tensors
(copied to the host with ``.cpu()``), numpy arrays, numpy scalars and
Python numbers; a dtype numpy cannot hold (bfloat16) raises.

Fault-tolerance contract:
  * a crash mid-save never corrupts the latest checkpoint (tmp dir + rename)
  * ``keep`` most-recent checkpoints are retained (bounded disk)
  * restore accepts another device or mesh than the one that saved:
    leaves are loaded as host arrays and placed on the caller's device,
    or spread over a mesh by the caller's shardings (elastic restore)
  * AsyncCheckpointer copies to the host first, then writes in a thread,
    one write in flight; an error surfaces on the next ``wait()``
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, DeviceLike, resolve_device

_SEP = "__"
_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _walk(tree, path: Tuple[str, ...] = (),
          leaf_types: tuple = _LEAF_TYPES) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _walk(tree[k], path + (str(k),), leaf_types)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += _walk(sub, path + (f"idx{i}",), leaf_types)
        return out
    if isinstance(tree, leaf_types):
        return [(_SEP.join(path), tree)]
    raise TypeError(f"checkpoint leaf of unsupported type "
                    f"{type(tree).__name__} at {_SEP.join(path)!r}")


def _rebuild(tree, fn: Callable[[str, Any], Any],
             path: Tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, fn, path + (f"idx{i}",))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(_SEP.join(path), tree)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (tensors copied with ``.cpu()``)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.is_meta:
            raise ValueError("a meta tensor holds no data to checkpoint")
        try:
            return leaf.detach().cpu().numpy()
        except TypeError as exc:         # bfloat16 and other torch-only types
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor: numpy "
                            "has no such dtype; cast it first") from exc
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    step's directory. Keeps the ``keep`` most recent steps."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": {}}
    for key, leaf in _walk(tree):
        arr = _host(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        meta["leaves"][key] = {"shape": list(arr.shape),
                               "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory`` (None when none)."""
    steps = _list_steps(directory)
    return max(steps) if steps else None


def load_meta(directory: str, step: int) -> Dict[str, Any]:
    """Read a checkpoint's meta.json (leaf shapes/dtypes) without loading
    the arrays: enough to build a target tree of ``device="meta"`` tensors
    when the caller does not know the saved shapes."""
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name, as ``meta.json`` stores it."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def restore_checkpoint(directory: str, step: int, target_tree,
                       shardings=None, device: Optional[DeviceLike] = None):
    """Restore step ``step`` into the structure of ``target_tree``.

    Target leaves may be tensors, numpy arrays or ``torch.empty(shape,
    dtype=..., device="meta")`` placeholders; each restored leaf is a
    tensor cast to the target's dtype. ``shardings`` is an optional tree
    of ``distributed.sharding.NamedSharding`` (or None) leaves in the
    target's structure, e.g. from ``sharding_for_tree``: a leaf with one
    becomes a DTensor spread over its mesh (``distribute_tensor`` with its
    placements, on the mesh's device type; every rank of the mesh calls
    this). A leaf without one goes to ``device``; with ``device`` None,
    where its target tensor lives, and a numpy or meta target to the
    default device (CUDA: pass ``device="cpu"`` without one).
    """
    from ..distributed.sharding import NamedSharding

    path = os.path.join(directory, f"step_{step:08d}")
    fixed = None if device is None else resolve_device(device)
    placed = dict(_walk(shardings, leaf_types=(NamedSharding,)))

    def load(key: str, target):
        arr = np.load(os.path.join(path, key + ".npy"))
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        sh = placed.get(key)
        if isinstance(target, torch.Tensor):
            want = target.dtype
            dev = target.device if not target.is_meta else None
        else:
            want = torch_dtype(str(getattr(target, "dtype",
                                           np.asarray(target).dtype)))
            dev = None
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor

            full = torch.from_numpy(arr).to(
                device=resolve_device(sh.mesh.device_type), dtype=want)
            return distribute_tensor(full, sh.mesh, sh.placements)
        dev = fixed or dev or resolve_device(DEFAULT_DEVICE)
        return torch.from_numpy(arr).to(device=dev, dtype=want)

    return _rebuild(target_tree, load)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with bounded queue depth 1."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree):
        """Copy ``tree`` to the host now, write it in the background."""
        self.wait()
        host_tree = _rebuild(tree, lambda _, leaf: np.array(_host(leaf),
                                                            copy=True))

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the write in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
