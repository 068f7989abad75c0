"""Fault tolerance for the training loop (the port's
``repro.train.fault_tolerance``).

Components:
  * `TrainLoop`: checkpoint/restart orchestration.  It resumes from the
    latest committed checkpoint, regenerates the data stream from the step
    index (the synthetic pipeline is stateless-resumable), saves
    periodically and on exit, and survives simulated preemptions: a
    restarted run's losses are bitwise the uninterrupted run's.
  * `StepWatchdog`: straggler mitigation.  It tracks a rolling step-time
    distribution; a step over ``threshold x median`` is a `StragglerEvent`
    for the orchestration layer (log, checkpoint, or raise).
  * `CorruptionPolicy`: the escalating response to nonfinite losses and to
    silent data corruption (below).

Where it differs from the JAX module:

* **State changes in place.**  The port's train step updates the model's
  parameters and the optimizer state in place (`train.step`).  The loop's
  ``train_step(params, opt_state, batch[, lr_scale]) -> (params,
  opt_state, metrics)`` is the JAX module's; `model_step` adapts the
  port's step to it.  A resume or rollback restores the checkpoint *into*
  the live tensors (`checkpoint.restore(target=...)`), which the fused
  step holds references to; a save copies them to the host before the next
  step may overwrite them (`checkpoint.save_async`).
* **The loop's own state is checkpointed.**  ``lr_scale``, the nonfinite
  streak and the data-stream offset go into each checkpoint's ``extra``
  and a resume takes them back, so a restarted trajectory is the
  uninterrupted one even after a backoff or a rollback (the JAX loop
  restarts them at 1, 0 and 0).  The AdamW step count, which feeds the
  bias correction and the fused flush's stochastic-rounding seed, is a
  leaf of the optimizer state.
* **A simulated preemption** (``fail_at``) joins the pending save before
  it raises, so the restarted run sees the same committed checkpoints on
  every run (a real preemption would lose the save in flight).
* **The SDC channel** reads `robust.abft.runtime_sdc_total()` after each
  step: the port's step counts its checks in a step scope and flushes them
  at its end, so no barrier is needed.
* **The end's save is not repeated**: when the last step's periodic or
  straggler save already holds the end state, the loop does not save the
  same step again (JAX's does, a second full write of the same tree).
* ``ckpt`` may be None: the loop then saves nothing and has nothing to
  resume or roll back to (the port's CLI without ``--ckpt-dir``; the JAX
  CLI writes to a fixed directory instead).
* The ``train/*`` spans and the structured ``[ft]`` events are ROADMAP
  item 15's; the lines go to ``logger`` as plain strings, and the
  ``train.*`` counters to `obs.metrics`.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.train.checkpoint import CheckpointManager

__all__ = [
    "CorruptionPolicy",
    "NonfinitePolicy",
    "StragglerEvent",
    "StepWatchdog",
    "TrainLoop",
    "model_step",
]


class StragglerEvent(RuntimeError):
    def __init__(self, step: int, elapsed: float, median: float):
        super().__init__(f"step {step} took {elapsed:.3f}s (> threshold x median {median:.3f}s)")
        self.step = step
        self.elapsed = elapsed
        self.median = median


class StepWatchdog:
    """Rolling-median step-time monitor.

    The first ``warmup_steps`` observations are discarded entirely: first
    launches (kernel builds, task tables, the allocator) make early steps
    far slower than steady state, and letting them into the rolling window
    both inflates the median (missing real stragglers) and flags the first
    steady step as one."""

    def __init__(self, threshold: float = 5.0, window: int = 50, min_samples: int = 5, warmup_steps: int = 0):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.warmup_steps = warmup_steps
        self._seen = 0
        self._times: List[float] = []

    def observe(self, step: int, elapsed: float) -> Optional[StragglerEvent]:
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return None
        ev = None
        if len(self._times) >= self.min_samples:
            med = float(np.median(self._times))
            if elapsed > self.threshold * med:
                ev = StragglerEvent(step, elapsed, med)
                obs_metrics.inc("train.straggler")
        self._times.append(elapsed)
        if len(self._times) > self.window:
            self._times.pop(0)
        return ev


@dataclasses.dataclass(frozen=True)
class CorruptionPolicy:
    """Escalating response to corrupted training steps.

    **Nonfinite loss.**  The update-side guardrail (`optim.adamw.
    clip_scale`'s scale-0 sentinel) already keeps a nonfinite gradient out
    of params and moments; this policy decides what the *loop* does about
    the streak:

      streak 1..skip_steps                  log and continue (skip)
      streak  ..skip_steps+backoff_steps    multiply lr by ``lr_backoff``
                                            each further nonfinite step
      beyond                                roll back to the last committed
                                            checkpoint and skip the data
                                            stream ahead past the poisoned
                                            window

    A finite loss resets the streak and restores the full lr.

    **Silent data corruption.**  With ``rollback_on_sdc=True`` and ABFT
    active on the step (``BackendConfig(abft="detect")``), the loop
    compares `robust.abft.runtime_sdc_total()` across each step.  A
    detection means a checksum mismatched *inside* the completed step: the
    corrupt update already landed in the parameters or moments (the fused
    optimizer's update flush is never retried in place), so skipping is
    not enough: the loop rolls back to the last committed checkpoint
    immediately and skips the data stream ahead.

    More than ``max_rollbacks`` rollbacks (either channel) raise: a
    deterministic divergence is a bug, not an infra fault."""

    skip_steps: int = 2
    backoff_steps: int = 3
    lr_backoff: float = 0.5
    max_rollbacks: int = 2
    rollback_on_sdc: bool = True


# legacy name: the nonfinite-only policy grew the SDC channel
NonfinitePolicy = CorruptionPolicy


def model_step(train_step: Callable) -> Callable:
    """The loop's ``(params, opt_state, batch, lr_scale=None) -> (params,
    opt_state, metrics)`` around the port's ``train_step(opt_state, batch,
    *, lr_scale=None) -> (opt_state, metrics)`` (`train.step.
    make_train_step`), which updates the model in place: ``params`` are the
    model's live parameters (``dict(model.named_parameters())``), passed
    through."""

    def step(params, opt_state, batch, lr_scale=None):
        opt_state, metrics = train_step(opt_state, batch, lr_scale=lr_scale)
        return params, opt_state, metrics

    return step


@dataclasses.dataclass
class TrainLoop:
    """Restartable training loop around a train step.

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    batch_fn(step) -> batch (pure function of step)
    """

    train_step: Callable
    batch_fn: Callable[[int], Dict[str, Any]]
    ckpt: Optional[CheckpointManager]
    watchdog: Optional[StepWatchdog] = None
    on_straggler: str = "log"  # log | checkpoint | raise
    # `corruption_policy` is the current name; `nonfinite_policy` is the
    # legacy spelling of the same slot (first non-None wins)
    nonfinite_policy: Optional[CorruptionPolicy] = None
    corruption_policy: Optional[CorruptionPolicy] = None
    # called after every committed step with the per-step metrics dict
    # (step, loss, dt_s, nonfinite_streak, sdc_delta, lr_scale)
    on_metrics: Optional[Callable[[Dict[str, Any]], None]] = None

    def _supports_lr_scale(self) -> bool:
        try:
            return "lr_scale" in inspect.signature(self.train_step).parameters
        except (TypeError, ValueError):
            return False

    def run(
        self,
        params: Any,
        opt_state: Any,
        *,
        num_steps: int,
        start_step: int = 0,
        resume: bool = True,
        fail_at: Optional[int] = None,  # test hook: simulate preemption
        log_every: int = 10,
        logger: Callable[[str], None] = print,
    ):
        step = start_step
        streak = 0  # consecutive nonfinite-loss steps
        lr_scale = 1.0
        rollbacks = 0
        # rollback skip-ahead: batch_fn(step + data_offset); replaying the
        # checkpointed steps on the batches that already poisoned them would
        # deterministically diverge again
        data_offset = 0
        ckpt = self.ckpt
        if resume and ckpt is not None:
            got_step, tree = ckpt.resume(target={"params": params, "opt": opt_state})
            if got_step is not None:
                params, opt_state = tree["params"], tree["opt"]
                step = got_step
                extra = ckpt.last_extra
                lr_scale = float(extra.get("lr_scale", 1.0))
                streak = int(extra.get("streak", 0))
                data_offset = int(extra.get("data_offset", 0))
                logger(f"[ft] resumed from checkpoint at step {step}")

        policy = self.corruption_policy if self.corruption_policy is not None else self.nonfinite_policy
        has_lr_scale = policy is not None and self._supports_lr_scale()
        watch_sdc = policy is not None and getattr(policy, "rollback_on_sdc", False)
        if watch_sdc:
            from repro_torch.robust import abft as _abft

        def tree():
            return {"params": params, "opt": opt_state}

        saved_at = None  # the step this run last saved, with nothing changed since

        def save(force=False):
            nonlocal saved_at
            if ckpt is not None:
                ckpt.maybe_save(step, tree(), force=force,
                                extra={"lr_scale": lr_scale, "streak": streak, "data_offset": data_offset})
                if force or step % ckpt.interval == 0:
                    saved_at = step

        def wait():
            if ckpt is not None:
                ckpt.wait()

        def rollback(cur_step, params, opt_state, why, reason):
            nonlocal rollbacks, data_offset, saved_at
            rollbacks += 1
            saved_at = None
            obs_metrics.inc("train.rollback", reason=reason)
            if rollbacks > policy.max_rollbacks:
                raise RuntimeError(
                    f"{why} persisted through {policy.max_rollbacks} rollbacks (step {cur_step}); "
                    "deterministic divergence is a bug, not an infra fault"
                )
            wait()  # a save in flight may be the one to roll back to
            got_step, restored = (None, None) if ckpt is None else ckpt.resume(
                target={"params": params, "opt": opt_state})
            if got_step is not None:
                data_offset += cur_step - got_step
                logger(f"[ft] {why}: rolled back {cur_step} -> {got_step}, "
                       f"data stream skipped ahead by {data_offset}")
                return got_step, restored["params"], restored["opt"]
            logger(f"[ft] {why} and no checkpoint to roll back to; continuing")
            return cur_step, params, opt_state

        history = []
        while step < num_steps:
            if fail_at is not None and step == fail_at:
                wait()
                raise KeyboardInterrupt(f"simulated preemption at step {step}")
            t0 = time.perf_counter()
            batch = self.batch_fn(step + data_offset)
            sdc_before = _abft.runtime_sdc_total() if watch_sdc else 0
            if has_lr_scale and lr_scale != 1.0:
                params, opt_state, metrics = self.train_step(params, opt_state, batch, lr_scale=lr_scale)
            else:
                params, opt_state, metrics = self.train_step(params, opt_state, batch)
            loss = float(metrics["loss"])  # waits for the device
            elapsed = time.perf_counter() - t0
            step += 1

            sdc_delta = 0
            if watch_sdc:
                sdc_delta = _abft.runtime_sdc_total() - sdc_before
                if sdc_delta:
                    # the corrupt update already landed in params/moments, so a
                    # skip is not enough: restore the last committed state and
                    # do NOT checkpoint or record the poisoned step
                    step, params, opt_state = rollback(
                        step, params, opt_state, f"SDC detected in step ({sdc_delta} checksum mismatches)", "sdc")
                    streak = 0
                    lr_scale = 1.0
                    continue

            history.append((step, loss))

            if policy is not None:
                if not math.isfinite(loss):
                    streak += 1
                    obs_metrics.inc("train.nonfinite")
                    if streak <= policy.skip_steps:
                        logger(f"[ft] nonfinite loss at step {step} (streak {streak}): update skipped")
                    elif streak <= policy.skip_steps + policy.backoff_steps:
                        if has_lr_scale:
                            lr_scale *= policy.lr_backoff
                            logger(f"[ft] nonfinite streak {streak}: lr backoff to {lr_scale:g}")
                        else:
                            logger(f"[ft] nonfinite streak {streak}: train_step has no lr_scale hook, "
                                   "continuing to skip")
                    else:
                        step, params, opt_state = rollback(step, params, opt_state, f"nonfinite streak {streak}",
                                                           "nonfinite")
                        streak = 0
                        lr_scale = 1.0
                else:
                    if streak or lr_scale != 1.0:
                        logger(f"[ft] recovered: finite loss at step {step}")
                    streak = 0
                    lr_scale = 1.0

            obs_metrics.inc("train.steps")
            obs_metrics.observe("train.step_us", elapsed * 1e6)
            if math.isfinite(loss):
                obs_metrics.set_gauge("train.loss", loss)
            if self.on_metrics is not None:
                self.on_metrics({
                    "step": step,
                    "loss": loss,
                    "dt_s": elapsed,
                    "nonfinite_streak": streak,
                    "sdc_delta": sdc_delta,
                    "lr_scale": lr_scale,
                })

            saved_this_step = False
            if self.watchdog is not None:
                ev = self.watchdog.observe(step, elapsed)
                if ev is not None:
                    if self.on_straggler == "raise":
                        save(force=True)
                        wait()
                        raise ev
                    logger(f"[ft] straggler: {ev}")
                    if self.on_straggler == "checkpoint":
                        save(force=True)
                        saved_this_step = True
            if not saved_this_step:
                # a straggler-forced save above already committed this step;
                # the periodic path would write the same tree twice
                save()
            if log_every and step % log_every == 0:
                logger(f"[train] step={step} loss={loss:.4f} dt={elapsed*1e3:.1f}ms")

        if saved_at != step:  # the last step's own save already holds the end state
            save(force=True)
        wait()
        return params, opt_state, history
