"""Fault tolerance & straggler mitigation for the training loop.

On a real 1000-node deployment, failures surface as (a) raised exceptions /
process death on the coordinator, (b) missing heartbeats from workers,
(c) stragglers (steps far above the running median). The primitives here are
deliberately host-level (pure Python around the step) so they apply to any
backend; the port of ``repro.distributed.fault``, unchanged:

  * `run_with_recovery`: catch -> restore-from-latest-checkpoint -> resume,
    with bounded restarts and exponential backoff. A `FaultInjector` hook
    exists purely so tests can exercise the path deterministically.
  * `StepMonitor`: per-step wall-time tracking; flags stragglers at
    `factor ×` the trailing median. The remediation (re-dispatching the
    work, excluding the host) is deployment-specific: the monitor exposes
    the decision, not the actuator.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class FaultInjector:
    """Deterministic fault injection for tests: raise at listed steps."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected fault at step {step}")


@dataclasses.dataclass
class StepMonitor:
    window: int = 32
    straggler_factor: float = 3.0

    def __post_init__(self):
        self.times = deque(maxlen=self.window)
        self.stragglers = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if seconds > self.straggler_factor * med:
                is_straggler = True
                self.stragglers.append((step, seconds, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs) — "
                            "would re-dispatch the work on a real cluster", step, seconds, med)
        self.times.append(seconds)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        if not self.times:
            return None
        return sorted(self.times)[len(self.times) // 2]


def run_with_recovery(train_loop: Callable[[int], int], *,
                      restore_step: Callable[[], int],
                      max_restarts: int = 3, backoff_s: float = 0.1) -> int:
    """Drive `train_loop(start_step) -> final_step`, restarting from the last
    checkpoint on failure. Returns the final step reached."""
    restarts = 0
    start = restore_step()
    while True:
        try:
            return train_loop(start)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any worker failure
            restarts += 1
            if restarts > max_restarts:
                log.error("exceeded %d restarts; giving up", max_restarts)
                raise
            wait = backoff_s * (2 ** (restarts - 1))
            log.warning("failure %r — restart %d/%d from checkpoint in %.2fs",
                        e, restarts, max_restarts, wait)
            time.sleep(wait)
            start = restore_step()
