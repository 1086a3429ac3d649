"""Fault injection and straggler detection (``repro.train.fault``).

* ``FailureInjector`` raises at a chosen step (standing in for a device
  or host loss); for the serving runtime it can also SIGKILL the process
  at a round boundary (the crash the journal and the supervisor recover
  from) and poison a live query's slot state with NaN (the corruption the
  runtime quarantines as ``POISONED``).
* ``run_with_restarts`` wraps a step loop: on failure it restarts from
  the latest verified step.  Its serving analogue is
  ``launch/supervise.py::run_with_recovery`` (journal replay).
* ``StragglerMonitor`` keeps an EMA of step times and flags outliers;
  ``SlotRuntime(straggler=...)`` feeds it per-round wall time
  (``SlotStats.straggler_rounds``).

Framework-free: the port keeps its own copy so that it imports nothing of
the JAX package.
"""
from __future__ import annotations

import os
import signal
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    """Deterministic fault injection, three modes (composable):

    ``fail_at_steps``  raise ``SimulatedFailure`` once per listed step.
    ``kill_at_steps``  SIGKILL this process at the listed step — nothing
                       downstream runs, exactly like a real crash; only a
                       supervisor in a PARENT process can recover.
    ``poison_qids``    with ``check(step, engine=...)``: while any listed
                       query is live, overwrite its slot's float state with
                       NaN via ``engine.poison_slot`` — persistent
                       corruption, re-applied every check, so retries keep
                       failing and the query must end ``POISONED``.
    """

    def __init__(self, fail_at_steps: set[int] = (), *,
                 kill_at_steps: set[int] = (), poison_qids: set[int] = ()):
        self.fail_at = set(fail_at_steps)
        self.kill_at = set(kill_at_steps)
        self.poison_qids = set(poison_qids)
        self.fired: set[int] = set()
        self.poison_events: list[tuple[int, int]] = []  # (step, qid)

    def check(self, step: int, engine=None):
        if engine is not None and self.poison_qids:
            for qid in sorted(self.poison_qids):
                slot = engine.runtime.slot_of(qid)
                if slot is not None:
                    engine.poison_slot(slot)
                    self.poison_events.append((step, qid))
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")
        if step in self.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.flags: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True when this step is a straggler."""
        self.count += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.count > self.warmup and dt > self.threshold * self.ema
        if is_straggler:
            self.flags.append(step)
        else:  # don't let outliers poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


def run_with_restarts(
    run_fn: Callable[[int], int],
    latest_step_fn: Callable[[], Optional[int]],
    max_restarts: int = 3,
) -> tuple[int, int]:
    """run_fn(start_step) -> final_step; restarts from the latest verified
    step on SimulatedFailure.  Returns (final_step, restarts_used)."""
    restarts = 0
    while True:
        start = latest_step_fn() or 0
        try:
            return run_fn(start), restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
