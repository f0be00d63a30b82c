"""Straggler, hang and numerical-anomaly detection for the training loop
(mirror of ``repro.distributed.monitor``: host threads and arithmetic, no
device code).

A host that slows down or hangs, or a step that goes non-finite, is met by
the ladder

    detect (this module) -> checkpoint -> restart -> resume from the
    deterministic stream position.

``StepTimeMonitor`` keeps an exponential moving average and variance of the
step wall time and flags steps beyond ``k`` sigmas or an absolute multiple of
the mean. ``Watchdog`` runs a timer thread that fires a callback if a step
exceeds a hard deadline, since a hung step never returns. ``HangGuard`` wires
both to an emergency checkpoint, and ``AnomalyMonitor`` answers each step's
loss and guard verdict with a rung of the numerical ladder.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional


class StepTimeMonitor:
    def __init__(self, ema_alpha: float = 0.05, sigma_k: float = 4.0,
                 abs_factor: float = 3.0, warmup_steps: int = 5,
                 min_rel: float = 1.25):
        self.alpha = ema_alpha
        self.sigma_k = sigma_k
        self.abs_factor = abs_factor
        self.warmup = warmup_steps
        # sigma-based detection needs a relative floor: exclusion feedback
        # shrinks the EWMA variance, so tiny jitter would otherwise flag
        self.min_rel = min_rel
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.stragglers: List[dict] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True when the step is flagged as a straggler."""
        self.n += 1
        if self.mean is None:
            self.mean = seconds
            return False
        flagged = False
        if self.n > self.warmup:
            sigma = self.var ** 0.5
            if (seconds > self.mean * self.abs_factor
                    or (sigma > 0 and seconds > self.mean * self.min_rel
                        and seconds > self.mean + self.sigma_k * sigma)):
                flagged = True
                self.stragglers.append(
                    {"step": step, "seconds": seconds, "mean": self.mean})
        # EMA update (straggler samples excluded so one hang doesn't mask
        # the next)
        if not flagged:
            d = seconds - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return flagged


class AnomalyMonitor:
    """Numerical-anomaly escalation ladder (host side of the resilience
    layer; the on-device half is ``repro_torch.train.pipeline``'s
    non-finite guard).

    Per step the launcher reports the loss plus the guard verdict and
    :meth:`record` answers with a rung:

    * ``"ok"``      — healthy; apply, maybe promote a pending checkpoint
      to last-known-good.
    * ``"skip"``    — the in-graph guard already masked the update (or the
      loss itself came back non-finite); nothing to undo, keep going, but
      burn one unit of the consecutive-skip budget.
    * ``"rewind"``  — the budget is gone (a *persistent* fault skipping is
      not clearing) or the loss spiked while staying finite (a fault the
      guard cannot see — e.g. a bounded int8 payload bit-flip — that has
      already poisoned the state, so skipping forward cannot help):
      restore the last-known-good checkpoint, back the LR off, replay.
    * ``"abort"``   — the rewind budget is gone too; fail loudly naming
      the offending step and leaves (:meth:`post_mortem`) rather than
      ship a silently-poisoned model.

    Loss-spike detection mirrors :class:`StepTimeMonitor`: EWMA mean /
    variance, a step flags when it exceeds ``abs_factor`` x mean or
    ``spike_k`` sigmas (with the ``min_rel`` floor, upward only — a loss
    *drop* is never an anomaly), after ``warmup_steps`` healthy samples.
    Anomalous samples never enter the EWMA."""

    def __init__(self, *, ema_alpha: float = 0.05, spike_k: float = 6.0,
                 abs_factor: float = 3.0, min_rel: float = 1.5,
                 warmup_steps: int = 8, skip_budget: int = 3,
                 rewind_budget: int = 2, leaf_names=()):
        self.alpha = ema_alpha
        self.spike_k = spike_k
        self.abs_factor = abs_factor
        self.min_rel = min_rel
        self.warmup = warmup_steps
        self.skip_budget = skip_budget
        self.rewind_budget = rewind_budget
        self.leaf_names = list(leaf_names)
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0
        self.consecutive_skips = 0
        self.rewinds = 0
        self.skips: List[dict] = []
        self.spikes: List[dict] = []

    def bad_leaves(self, flags) -> List[str]:
        """Names of the flag units the guard reported non-finite (flag
        falsy), by index into ``leaf_names`` (the order of
        ``repro_torch.train.pipeline.guard_flag_names``)."""
        if flags is None:
            return []
        out = []
        for i, f in enumerate(flags):
            if not bool(f):
                out.append(self.leaf_names[i] if i < len(self.leaf_names)
                           else f"flag_{i}")
        return out

    def record(self, step: int, loss: float, skipped: bool = False,
               flags=None) -> str:
        """Report step ``step``; returns the rung (see class docstring)."""
        finite = loss == loss and abs(loss) != float("inf")
        if skipped or not finite:
            self.consecutive_skips += 1
            self.skips.append({"step": step, "loss": loss,
                               "leaves": self.bad_leaves(flags)})
            if self.consecutive_skips > self.skip_budget:
                return self._escalate()
            return "skip"
        self.consecutive_skips = 0
        self.n += 1
        if self.mean is None:
            self.mean = loss
            return "ok"
        if self.n > self.warmup:
            sigma = self.var ** 0.5
            if (loss > self.mean * self.abs_factor
                    or (sigma > 0 and loss > self.mean * self.min_rel
                        and loss > self.mean + self.spike_k * sigma)):
                self.spikes.append(
                    {"step": step, "loss": loss, "mean": self.mean})
                # a finite spike means the poison is already *in* the
                # state — skipping forward can't undo an applied update,
                # so a spike escalates straight to the rewind rung
                return self._escalate()
        d = loss - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return "ok"

    def _escalate(self) -> str:
        self.consecutive_skips = 0
        self.rewinds += 1
        return "abort" if self.rewinds > self.rewind_budget else "rewind"

    def post_mortem(self) -> str:
        """One line naming what went wrong and where — the abort message."""
        parts = []
        if self.skips:
            last = self.skips[-1]
            leaves = ", ".join(last["leaves"]) or "<none flagged>"
            parts.append(f"last skipped step {last['step']} "
                         f"(non-finite: {leaves}); "
                         f"{len(self.skips)} skips total")
        if self.spikes:
            last = self.spikes[-1]
            parts.append(f"last loss spike at step {last['step']} "
                         f"({last['loss']:.4g} vs EWMA {last['mean']:.4g})")
        parts.append(f"{self.rewinds} rewinds "
                     f"(budget {self.rewind_budget})")
        return "; ".join(parts)


class HangGuard:
    """Wires the two detect rungs to the checkpoint rung of the ladder.

    * :class:`Watchdog` with a hard per-step deadline: a hung collective
      never returns, so only the timer thread can act — it calls
      ``save_fn`` (an emergency *blocking* checkpoint of the last completed
      step).  ``save_fn`` must read a host-side snapshot of the state: the
      in-flight step may still be computing the live tensors when the
      watchdog fires.
    * :class:`StepTimeMonitor`: a flagged straggler step triggers the same
      emergency save — the launcher's cue to restart without the slow host.

    The remaining rung is ``repro_torch.checkpoint.manager`` (atomic
    commit, so the checkpoint survives the kill that follows).

    Usage: ``arm()`` before launching each step, ``record()`` after it
    completes (with the fresh snapshot already in place), ``stop()`` when
    the loop exits."""

    def __init__(self, deadline_s: float, save_fn: Callable[[], None],
                 monitor: Optional["StepTimeMonitor"] = None):
        self.monitor = monitor or StepTimeMonitor()
        self._save = save_fn
        self.fired = False   # hard-deadline timeouts seen
        self.flagged = 0     # straggler steps seen
        # the timer thread and the main loop may both reach the save
        self._saving = threading.Lock()
        self.watchdog = (Watchdog(deadline_s, self._on_timeout)
                         if deadline_s else None)

    def _emergency_save(self, why: str):
        with self._saving:
            print(f"[watchdog] {why} — emergency checkpoint", flush=True)
            self._save()

    def _on_timeout(self):
        self.fired = True
        self._emergency_save(
            f"step exceeded the {self.watchdog.deadline:.1f}s hard deadline")

    def arm(self):
        if self.watchdog is not None:
            self.watchdog.pet()

    def record(self, step: int, seconds: float) -> bool:
        flagged = self.monitor.record(step, seconds)
        if flagged:
            self.flagged += 1
            self._emergency_save(
                f"step {step} flagged as straggler "
                f"({seconds:.2f}s vs mean {self.monitor.mean:.2f}s)")
        return flagged

    def stop(self):
        if self.watchdog is not None:
            self.watchdog.stop()


class Watchdog:
    """Fires ``on_timeout`` if ``pet`` is not called within ``deadline_s``."""

    def __init__(self, deadline_s: float, on_timeout: Callable[[], None]):
        self.deadline = deadline_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()

    def pet(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.deadline, self.on_timeout)
            self._timer.daemon = True
            self._timer.start()

    def stop(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
