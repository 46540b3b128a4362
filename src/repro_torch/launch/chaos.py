"""Fault injection for the smoother service — the JAX package's
``launch/chaos.py``, drawing from the same seeded numpy streams, so the
same requests and the same flushes are hit in both packages.

The failure taxonomy the service claims to handle:

  * **NaN observations** — a corrupted sensor frame inside a request
    payload; the lane diverges and must be frozen and verdicted, never
    poisoning the lanes batched with it;
  * **outlier observations** — absurd-magnitude measurements (a
    client-side unit mix-up); adaptive damping absorbs them or the lane
    diverges cleanly;
  * **transient compute exceptions** — a flush that fails once and
    succeeds when retried in place (`repro_torch.runtime.with_retries`),
    so results stay bit-identical;
  * **injected stragglers** — a flush whose measured wall time is
    inflated; the `StepWatchdog` flags it and the compute EMA does not
    absorb it.

Injection happens at the two seams of the discrete-event service loop:
the request payloads before enqueue (`ChaosInjector.corrupt_requests`,
which takes tensors and clones each one it corrupts) and the flush
executor (`ChaosInjector.wrap_execute`). The injector keeps a ledger of what it
did (`faults`, `log`), so a run can check that every injected fault got
an explicit verdict.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np


class TransientComputeError(RuntimeError):
    """Injected transient executor failure: raised once per flush, so an
    in-place bounded retry (`repro_torch.runtime.with_retries`)
    succeeds."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded, rate-controlled fault-injection knobs.

    Request-level rates (``nan_rate``/``outlier_rate``) are per-request
    corruption probabilities; flush-level rates
    (``exception_rate``/``straggler_rate``) are per launch. All default
    to 0 (no injection).
    """

    seed: int = 0
    nan_rate: float = 0.0         # P[request gets a NaN observation]
    outlier_rate: float = 0.0     # P[request gets absurd outliers]
    outlier_scale: float = 1e6    # outlier magnitude multiplier
    exception_rate: float = 0.0   # P[flush raises once (transient)]
    straggler_rate: float = 0.0   # P[flush wall time inflated]
    straggler_factor: float = 4.0

    def __post_init__(self):
        for name in ("nan_rate", "outlier_rate", "exception_rate",
                     "straggler_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor must be >= 1")

    @classmethod
    def at_rate(cls, rate: float, seed: int = 0) -> "ChaosConfig":
        """The fault mix at one headline rate: ``rate`` of requests get a
        NaN observation, and ``rate`` of flushes are hit by a transient
        exception and by a straggler each."""
        return cls(seed=seed, nan_rate=rate, exception_rate=rate,
                   straggler_rate=rate)

    @property
    def active(self) -> bool:
        return (self.nan_rate > 0 or self.outlier_rate > 0
                or self.exception_rate > 0 or self.straggler_rate > 0)


class ChaosInjector:
    """Stateful injector over one service run.

    Request corruption draws from one rng stream (indexed by request
    order, so the corrupted *set* is deterministic per seed regardless of
    flush timing), executor faults from a second (flush-order dependent —
    they only perturb timing and retries, never results).
    """

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._req_rng = np.random.default_rng(cfg.seed)
        self._flush_rng = np.random.default_rng(cfg.seed + 1)
        self.faults: Dict[int, str] = {}    # request index -> fault kind
        self.log = {"exceptions": 0, "stragglers": 0}
        self._raised: set = set()

    def corrupt_requests(self, requests: List) -> Tuple[List, Dict[int, str]]:
        """Corrupt a seeded subset of request payloads.

        Accepts a list of ``ys`` tensors or ``(tenant, ys)`` pairs (the
        single- and multi-tenant fleet shapes); returns a new list, in
        which each corrupted payload is a clone and every other one the
        caller's own tensor, plus ``{request index: fault kind}``.
        """
        out = []
        for idx, item in enumerate(requests):
            tenant, ys = (item if isinstance(item, tuple)
                          else (None, item))
            u = self._req_rng.random()
            k = int(self._req_rng.integers(len(ys)))
            if u < self.cfg.nan_rate:
                ys = ys.clone()
                ys[k] = float("nan")
                self.faults[idx] = "nan_obs"
            elif u < self.cfg.nan_rate + self.cfg.outlier_rate:
                ys = ys.clone()
                ys[k] = (ys[k].abs() + 1.0) * self.cfg.outlier_scale
                self.faults[idx] = "outlier_obs"
            out.append((tenant, ys) if tenant is not None else ys)
        return out, dict(self.faults)

    def wrap_execute(self, execute: Callable) -> Callable:
        """Wrap a flush executor with transient exceptions and straggler
        inflation.

        An injected `TransientComputeError` fires at most once per flush
        identity (so `with_retries` around the wrapped executor succeeds
        on the retry, bit-identically — nothing ran before the raise);
        straggler injection multiplies the *reported* wall seconds the
        simulated serial executor is charged, leaving results untouched.
        """
        def chaotic(fl):
            key = (fl.signature, fl.at,
                   tuple(r.req_id for r in fl.requests))
            if (key not in self._raised
                    and self._flush_rng.random()
                    < self.cfg.exception_rate):
                self._raised.add(key)
                self.log["exceptions"] += 1
                raise TransientComputeError(
                    f"injected transient fault on {fl.signature}")
            res = execute(fl)
            dt, outcomes = (res if isinstance(res, tuple) else (res, {}))
            if self._flush_rng.random() < self.cfg.straggler_rate:
                self.log["stragglers"] += 1
                dt = float(dt) * self.cfg.straggler_factor
            return dt, outcomes
        return chaotic

    def summary(self) -> dict:
        kinds: Dict[str, int] = {}
        for k in self.faults.values():
            kinds[k] = kinds.get(k, 0) + 1
        return {"config": dataclasses.asdict(self.cfg),
                "corrupted_requests": dict(self.faults),
                "fault_kinds": kinds, **self.log}
