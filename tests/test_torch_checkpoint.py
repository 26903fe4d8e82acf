"""Port parity: the checkpoint store (``repro_torch.checkpoint``).

The twins of ``tests/test_checkpoint.py`` (the elastic restore places
leaves with ``device="cpu"``, ROADMAP difference 13), and a tree crossing
the two stores both ways with its ``.npy`` leaves and ``meta.json``
byte-identical. Stream checkpoints and the launcher's flags are in
``tests/test_torch_checkpoint_stream.py``.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import os

import numpy as np
import pytest
import torch

import jax
from repro import checkpoint as RC
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_meta, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.stream import StreamSession

CPU = "cpu"


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "blocks": [{"a": torch.ones(5)},
                                  {"a": torch.zeros(2)}]},
            "step": torch.tensor(7)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = _tree()
    save_checkpoint(d, 10, tree)
    assert latest_step(d) == 10
    target = {"params": {"w": np.zeros((3, 4), np.float32),
                         "blocks": [{"a": np.zeros(5, np.float32)},
                                    {"a": np.zeros(2, np.float32)}]},
              "step": np.int64(0)}
    restored = restore_checkpoint(d, 10, target, device=CPU)
    for a, b in zip(_leaves(tree), _leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert restored["step"].shape == () and restored["step"].dtype == \
        torch.int64


def test_gc_keeps_most_recent(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        save_checkpoint(d, s, _tree(), keep=3)
    names = sorted(os.listdir(d))
    assert names == ["step_00000003", "step_00000004", "step_00000005"]


def test_restore_respects_target_dtype(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, {"w": torch.ones(4, dtype=torch.float32)})
    target = {"w": torch.empty(4, dtype=torch.bfloat16, device="meta")}
    out = restore_checkpoint(d, 1, target, device=CPU)
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.ones(4, dtype=torch.bfloat16))
    # numpy holds no bfloat16: saving such a leaf raises, it is not cast
    with pytest.raises(TypeError, match="bfloat16"):
        save_checkpoint(d, 2, {"w": torch.ones(4, dtype=torch.bfloat16)})
    assert latest_step(d) == 1


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(d, keep=2)
    tree = _tree()
    for s in (1, 2, 3):
        ck.save(s, tree)
        tree["params"]["w"] += 1.0     # the copy was taken before the write
    ck.wait()
    assert latest_step(d) == 3
    meta = load_meta(d, 3)
    assert meta["leaves"]["params__w"] == {"shape": [3, 4],
                                           "dtype": "float32"}
    w = np.load(os.path.join(d, "step_00000003", "params__w.npy"))
    np.testing.assert_array_equal(w, np.arange(12.0).reshape(3, 4) + 2.0)
    # an error surfaces on the next wait()
    bad = AsyncCheckpointer(str(tmp_path / "file"))
    (tmp_path / "file").write_text("not a directory")
    bad.save(1, {"x": np.ones(2)})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                          # raised once, then cleared


def test_crash_mid_save_leaves_previous_intact(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _tree())
    # simulate a torn write: tmp dir exists but was never renamed
    os.makedirs(os.path.join(d, "step_00000002.tmp.999"), exist_ok=True)
    assert latest_step(d) == 1  # tmp dirs are invisible to discovery


def test_elastic_restore_with_new_sharding(tmp_path):
    """Restore onto an explicit device (the port's stand-in for the
    reference's shardings, ROADMAP difference 13): a CUDA-saved tree comes
    back on the CPU, a numpy target too."""
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    save_checkpoint(d, 5, tree)
    out = restore_checkpoint(d, 5, tree, device=CPU)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"].numpy())
    assert out["w"].device == torch.device(CPU)
    out = restore_checkpoint(d, 5, {"w": np.zeros((4, 4), np.float64)},
                             device=CPU)
    assert out["w"].dtype == torch.float64


# ---------------------------------------------------------------------------
# the two stores read each other's checkpoints
# ---------------------------------------------------------------------------

def _np_tree():
    rng = np.random.default_rng(0)
    return {"b": [rng.integers(0, 9, (3, 2)).astype(np.int64),
                  (np.float32(2.5), rng.random(4).astype(np.float32))],
            "a": {"z": np.arange(5, dtype=np.uint32),
                  "m": np.array([True, False])},
            "s": np.int64(9), "none": None,
            "c": np.frombuffer(b'{"x": 1}', dtype=np.uint8).copy()}


def test_trees_cross_both_stores_byte_identical(tmp_path):
    """The same numpy tree saved by each store: the same files, each
    byte-identical (``meta.json`` included); each store restores the
    other's checkpoint to the saved values."""
    tree = _np_tree()
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RC.save_checkpoint(ref_dir, 4, tree)
    save_checkpoint(port_dir, 4, tree)
    ref_step = os.path.join(ref_dir, "step_00000004")
    port_step = os.path.join(port_dir, "step_00000004")
    assert sorted(os.listdir(ref_step)) == sorted(os.listdir(port_step))
    for name in os.listdir(ref_step):
        with open(os.path.join(ref_step, name), "rb") as f:
            want = f.read()
        with open(os.path.join(port_step, name), "rb") as f:
            assert f.read() == want, name
    flat = _leaves(tree)
    # the port restores the reference's checkpoint
    got = restore_checkpoint(ref_dir, 4, tree, device=CPU)
    for a, b in zip(flat, _leaves(got)):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the reference restores the port's (int32 under jax's default x32)
    ref_target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        np.shape(x), np.asarray(x).dtype), tree)
    back = RC.restore_checkpoint(port_dir, 4, ref_target)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        StreamSession.restore(str(tmp_path), device=CPU)
