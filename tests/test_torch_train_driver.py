"""The port's training loop (``launch/train.py``) on the CPU: the twins
of ``tests/test_system.py``'s training tests, the straggler monitor, a
mesh run outside a process group, and the launcher.

The reference's tests check its own ``train``; these hold the port's to
the same claims. A resumed run is bit-identical to a straight one: the
checkpoint holds every float32 leaf exactly, and the CPU step is
deterministic.
"""
import test_torch_threads  # noqa: F401 (caps torch's threads under xdist)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.distributed.fault import FaultInjector, StepMonitor
from repro_torch.launch.train import TrainRunConfig, train

ROOT = Path(__file__).resolve().parents[1]


def test_train_loop_loss_decreases():
    run = TrainRunConfig(arch="gemma_2b", steps=25, global_batch=8,
                         seq_len=32, d_model=64, layers=2, lr=5e-3,
                         vocab_size=128)
    _, hist = train(run, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_train_recovers_from_injected_fault(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    run = TrainRunConfig(arch="qwen3_8b", steps=24, global_batch=4,
                         seq_len=32, d_model=64, layers=2, vocab_size=128,
                         ckpt_dir=ckpt, ckpt_every=6)
    fault = FaultInjector(fail_at_steps=[13])
    _, hist = train(run, fault=fault, device="cpu")
    steps_seen = [h["step"] for h in hist]
    assert 13 in fault.fired
    # restarted from the step-12 checkpoint and completed
    assert steps_seen.count(12) >= 1
    assert steps_seen[-1] == 23


def test_train_resume_is_bit_identical(tmp_path):
    """The same losses, bit for bit, at every step after a restart from
    the step-6 checkpoint as in a straight run."""
    base = dict(arch="gemma_2b", steps=12, global_batch=4, seq_len=32,
                d_model=64, layers=2, vocab_size=128, ckpt_every=6)
    _, h1 = train(TrainRunConfig(**base, ckpt_dir=str(tmp_path / "a")),
                  device="cpu")
    fault = FaultInjector(fail_at_steps=[7])
    _, h2 = train(TrainRunConfig(**base, ckpt_dir=str(tmp_path / "b")),
                  fault=fault, device="cpu")
    l1 = {h["step"]: h["loss"] for h in h1}
    l2 = {h["step"]: h["loss"] for h in h2}
    assert 7 in fault.fired and [h["step"] for h in h2].count(6) == 2
    assert all(l1[s] == l2[s] for s in range(12)), (l1, l2)


def test_compressed_grads_trains():
    run = TrainRunConfig(arch="gemma_2b", steps=15, global_batch=4,
                         seq_len=32, d_model=64, layers=2, vocab_size=128,
                         compress_grads=True)
    state, hist = train(run, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(state["ef"]) == {n for n, _ in
                                state["params"].named_parameters()}


def test_adafactor_driver():
    """Adafactor through ``train`` descends (slower than AdamW by design:
    a decaying beta2 and update clipping need more steps)."""
    run = TrainRunConfig(arch="gemma_2b", steps=100, global_batch=8,
                         seq_len=32, d_model=64, layers=2, vocab_size=128,
                         optimizer="adafactor", lr=3e-2, warmup=10)
    _, hist = train(run, device="cpu")
    assert np.mean([h["loss"] for h in hist[-10:]]) < hist[0]["loss"] - 0.05


def test_step_monitor_flags_stragglers():
    mon = StepMonitor(window=16, straggler_factor=2.0)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 0.5)
    assert not mon.record(11, 0.12)
    assert mon.median == 0.1 and mon.stragglers[0][0] == 10


def test_mesh_waits_for_production_sharding():
    """A (data, model) mesh other than (1, 1) trains over the ranks of a
    process group (``test_torch_train_mesh.py``); outside one it raises
    before any state is built, rather than train on one process."""
    with pytest.raises(RuntimeError, match="process group"):
        train(TrainRunConfig(mesh_shape=(2, 1)), device="cpu")


def test_launcher_trains_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` with a
    checkpoint directory: the final step's checkpoint is written."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma_2b", "--steps", "4", "--global-batch", "2", "--seq-len",
         "16", "--d-model", "32", "--layers", "1", "--ckpt-dir",
         str(tmp_path), "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("first loss ") and "on cpu" in out.stdout
    assert (tmp_path / "step_00000004" / "meta.json").exists()
