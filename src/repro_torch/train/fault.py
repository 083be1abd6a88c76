"""Fault tolerance: the restart driver, failure injection, straggler
detection.

Port of the JAX package's ``train/fault.py`` for one card.  ``TrainDriver``
wraps the step with:

* periodic async checkpoints (atomic publish, see checkpoint.py);
* restart on failure: a :class:`SimulatedNodeFailure` rolls the state back
  to the last published checkpoint and replays; the data is a pure
  function of (seed, step) and the step's kernels use no atomics, so the
  replay repeats the first pass;
* straggler detection: a step slower than ``straggler_factor`` times the
  median of the recent window is recorded in ``events`` and handed to
  :meth:`mitigate_straggler`.  Step times come from ``clock`` (default
  ``time.perf_counter``), read after the step's device work has finished,
  so a test can drive a fake clock.

``resume_elastic`` restores the latest checkpoint onto another mesh (its
leaves as ``DTensor``s of the new layouts).
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.models import tree
from repro_torch.train import checkpoint as ckpt_lib


class SimulatedNodeFailure(RuntimeError):
    """Raised by failure-injection hooks to emulate a lost node."""


@dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    keep: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 16
    max_restarts: int = 8


def _finish(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@dataclass
class TrainDriver:
    cfg: DriverConfig
    step_fn: Callable                     # (state, batch) -> (state, metrics)
    batch_fn: Callable                    # step -> batch (deterministic)
    state: Any
    clock: Callable[[], float] = time.perf_counter
    on_step: Callable | None = None       # (step, metrics) after each step
    shardings: Any = None                 # restore layouts (elastic resume)
    events: list = field(default_factory=list)
    step_ms: list = field(default_factory=list)   # each step run, replays in
    _times: list = field(default_factory=list)

    def __post_init__(self):
        self._ckpt = ckpt_lib.AsyncCheckpointer(self.cfg.ckpt_dir,
                                                keep=self.cfg.keep)
        self._restarts = 0
        self.device = self.state["step"].device

    @property
    def step(self) -> int:
        return int(self.state["step"])

    def _detect_straggler(self, dt: float, step: int):
        self._times.append(dt)
        window = self._times[-self.cfg.straggler_window:]
        if len(window) >= 4:
            med = statistics.median(window[:-1])
            if dt > self.cfg.straggler_factor * med:
                self.events.append(("straggler", step, dt, med))
                self.mitigate_straggler(step, dt, med)

    def mitigate_straggler(self, step: int, dt: float, median: float):
        """Hook: on a cluster, quarantine the slow host.  Default: record
        only (tests read ``events``)."""

    def run(self, n_steps: int, *, failure_hook: Callable | None = None):
        """Run ``n_steps``, surviving injected failures by restart and
        replay."""
        target = self.step + n_steps
        while self.step < target:
            step = self.step
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = self.batch_fn(step)
                t0 = self.clock()
                self.state, metrics = self.step_fn(self.state, batch)
                _finish(metrics["loss"])
                dt = self.clock() - t0
                self.step_ms.append(1e3 * dt)
                self._detect_straggler(dt, step)
                if self.on_step is not None:
                    self.on_step(step, metrics)
                new_step = step + 1
                if new_step % self.cfg.ckpt_every == 0:
                    t0 = self.clock()
                    self._ckpt.save_async(self.state, new_step)
                    # The host snapshot's seconds (the write goes on).
                    self.events.append(("checkpoint", new_step,
                                        self.clock() - t0))
            except SimulatedNodeFailure as e:
                self._restarts += 1
                self.events.append(("failure", step, str(e)))
                if self._restarts > self.cfg.max_restarts:
                    raise
                self._restore()
        self._ckpt.wait()
        return self.state

    def _restore(self):
        self._ckpt.wait()
        steps = ckpt_lib.latest_steps(self.cfg.ckpt_dir)
        if not steps:
            self.events.append(("restart_from_init", 0))
            return                      # keep the current state
        like = tree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            self.state)
        # The lost state goes before the checkpoint comes in: a card holds
        # one train state of a model this size, not two.
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = self.clock()
        self.state, step = ckpt_lib.restore(self.cfg.ckpt_dir, like,
                                            device=self.device,
                                            shardings=self.shardings)
        _finish(self.state["step"])
        self.events.append(("restored", step, self.clock() - t0))

    def resume_elastic(self, state_like: Any, shardings: Any):
        """Elastic restart: the latest checkpoint restored onto a new mesh
        (another rank count or layout), each leaf laid out by
        ``shardings``."""
        self._ckpt.wait()
        self.shardings = shardings
        self.state, step = ckpt_lib.restore(self.cfg.ckpt_dir, state_like,
                                            device=self.device,
                                            shardings=shardings)
        self.events.append(("elastic_resume", step))
        return self.state
