"""Step watchdog (straggler detection), preemption handling (SIGTERM ->
checkpoint) and a bounded-retry wrapper for transient step failures —
the JAX package's ``runtime/fault.py``, value for value.

The service feeds the watchdog each flush's measured compute seconds, the
trainer each step's: an EMA-based detector flags launches far above the
running mean, so one outlier is reported and kept out of the baseline.
A preemption (maintenance events send SIGTERM) sets a flag; the training
loop checkpoints and stops at the next step boundary.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    ema: float
    ratio: float


class StepWatchdog:
    """EMA-based step-time anomaly detector."""

    def __init__(self, threshold: float = 2.0, ema_decay: float = 0.9,
                 warmup_steps: int = 3):
        self.threshold = threshold
        self.ema_decay = ema_decay
        self.warmup_steps = warmup_steps
        self._ema: Optional[float] = None
        self._count = 0
        self.reports: List[StragglerReport] = []

    def observe(self, step: int, duration: float) -> Optional[StragglerReport]:
        self._count += 1
        if self._ema is None:
            self._ema = duration
            return None
        ratio = duration / max(self._ema, 1e-9)
        if self._count > self.warmup_steps and ratio > self.threshold:
            report = StragglerReport(step=step, duration=duration,
                                     ema=self._ema, ratio=ratio)
            self.reports.append(report)
            # Do not fold outliers into the EMA.
            return report
        self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) \
            * duration
        return None


class PreemptionHandler:
    """SIGTERM/SIGINT -> set flag; the training loop checkpoints and exits
    cleanly at the next step boundary."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._installed = False
        self._prev = {}

    def install(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._installed = False

    def _on_signal(self, signum, frame):
        self._requested = True

    @property
    def preemption_requested(self) -> bool:
        return self._requested


def with_retries(fn: Callable, *, max_retries: int = 2,
                 retry_on: tuple = (RuntimeError,),
                 on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Bounded-retry wrapper: transient failures (``retry_on``) are retried
    up to ``max_retries`` times; persistent ones re-raise the last error."""

    def wrapped(*args, **kwargs):
        err: Optional[Exception] = None
        for attempt in range(max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                err = e
                if on_retry is not None:
                    on_retry(attempt, e)
        raise err

    return wrapped
