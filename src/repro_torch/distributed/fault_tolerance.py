"""Fault tolerance and elasticity for long-running training (port of
``repro.distributed.fault_tolerance``).

* ``TrainSupervisor`` — the outer loop a job runs under: checkpoint every K
  steps (async, atomic), restore from the latest on (re)start, a bounded
  restart budget, a step-deadline straggler hook.
* ``elastic_restore`` — resume onto another device: checkpoints are stored
  whole with their tree paths, so the new job puts them where it runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint import Checkpointer


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    max_restarts: int = 3
    step_deadline_s: float | None = None   # straggler detection


class StepDeadlineExceeded(RuntimeError):
    pass


class TrainSupervisor:
    """Runs ``step_fn(state, step) -> state`` with checkpoint/restart
    semantics. ``state`` is any checkpointable tree (the model, the
    optimizer state, ...); ``make_state()`` builds the fresh-start state,
    which a restore overwrites when a checkpoint exists (onto ``device``
    if given)."""

    def __init__(self, cfg: SupervisorConfig, make_state: Callable[[], dict],
                 step_fn: Callable, *, device=None):
        self.cfg = cfg
        self.make_state = make_state
        self.step_fn = step_fn
        self.device = device
        self.ckpt = Checkpointer(cfg.ckpt_dir)
        self.restarts = 0
        self.events: list = []

    def _restore_or_init(self):
        template = self.make_state()
        step, state = self.ckpt.restore_latest(template, self.device)
        if state is None:
            return 0, template
        self.events.append(("restored", step))
        return step + 1, state

    def run(self, total_steps: int):
        while True:
            start, state = self._restore_or_init()
            try:
                for step in range(start, total_steps):
                    t0 = time.monotonic()
                    state = self.step_fn(state, step)
                    dt = time.monotonic() - t0
                    if (self.cfg.step_deadline_s is not None
                            and dt > self.cfg.step_deadline_s):
                        self.events.append(("straggler", step, dt))
                        raise StepDeadlineExceeded(
                            f"step {step} took {dt:.3f}s")
                    if (step + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save_async(step, state)
                self.ckpt.wait()
                self.ckpt.save_async(total_steps - 1, state)
                self.ckpt.wait()
                return state
            except Exception as e:  # node failure / straggler abort
                self.ckpt.wait()
                self.restarts += 1
                self.events.append(("restart", self.restarts, repr(e)))
                if self.restarts > self.cfg.max_restarts:
                    raise


def elastic_restore(ckpt_dir: str, template_tree, device):
    """Restore the latest checkpoint onto ``device`` (another card, or the
    CPU, than the job that wrote it). Returns (step, state) or (None,
    None)."""
    return Checkpointer(ckpt_dir).restore_latest(template_tree, device)
