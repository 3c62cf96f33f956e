"""Fault tolerance: the checkpoint/restart loop, failure injection and the
straggler watchdog, the counterparts of ``repro.runtime.fault_tolerance``.

* every N steps an atomic checkpoint is written (``checkpoint.manager``;
  the snapshot is copied to the host before the step that follows);
* any exception in the step triggers restore-from-latest and replay (the
  data pipeline is seeded by step number, so replay is deterministic).
  The port's steps update the state in place, so a step that raised
  mid-update may have left parameters half updated: the restore copies
  every leaf of the checkpoint into the state (``load_into``), on the
  state's devices and in its dtypes, so nothing of that step survives.
  With no checkpoint yet, the loop replays from its start on the state as
  it stands, as the reference does;
* a step-time watchdog flags stragglers (step > factor x rolling median)
  and calls a policy callback.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager

log = logging.getLogger(__name__)


class FailureInjector:
    """Deterministically raise at given steps (for tests/chaos drills)."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected failure at step {step}")


@dataclass
class StepWatchdog:
    """Rolling-median straggler detection."""
    factor: float = 3.0
    window: int = 32
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float):
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        if len(self.times) >= 8 and seconds > self.factor * med:
            self.events.append((step, seconds, med))
            log.warning("straggler: step %d took %.3fs (median %.3fs)",
                        step, seconds, med)
            if self.on_straggler:
                self.on_straggler(step, seconds, med)


def load_into(state, restored):
    """Copy a restored tree (numpy arrays, or CPU tensors for bf16 leaves)
    into ``state``'s tensors in place, each on its device and in its dtype;
    returns ``state``.  A leaf of ``state`` that is not a tensor is
    replaced by the restored value."""
    if isinstance(state, dict):
        for k in state:
            state[k] = load_into(state[k], restored[k])
        return state
    if isinstance(state, list):
        for i in range(len(state)):
            state[i] = load_into(state[i], restored[i])
        return state
    src = restored if isinstance(restored, torch.Tensor) else \
        torch.from_numpy(np.array(restored, copy=True))
    if not isinstance(state, torch.Tensor):
        return src
    with torch.no_grad():
        state.copy_(src.to(state.dtype))
    return state


class TrainLoopRunner:
    """Checkpointed, restartable training loop.

    step_fn(state, batch) -> (state, metrics); batch_fn(step) -> batch
    (step-seeded so replay after restore is deterministic).
    """

    def __init__(self, step_fn, batch_fn, ckpt: CheckpointManager, *,
                 failure_injector: FailureInjector | None = None,
                 watchdog: StepWatchdog | None = None,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.injector = failure_injector
        self.watchdog = watchdog or StepWatchdog()
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, num_steps: int, start_step: int = 0):
        step = start_step
        metrics_log = []
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                if self.injector:
                    self.injector.check(step)
                batch = self.batch_fn(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                metrics_log.append({"step": step, "seconds": dt, **metrics})
                step += 1
                self.ckpt.maybe_save(step, state)
            except Exception as e:  # noqa: BLE001 - restart on anything
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring latest "
                            "checkpoint (restart %d/%d)", step, e,
                            self.restarts, self.max_restarts)
                restored, ckpt_step = self.ckpt.restore_latest(state)
                if restored is None:
                    ckpt_step = start_step
                else:
                    state = load_into(state, restored)
                step = ckpt_step
        self.ckpt.wait()
        return state, metrics_log
