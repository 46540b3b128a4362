"""Deadline-aware autobatching queue of the smoother service — the JAX
package's ``launch/autobatch.py``, value for value, so flush sequences,
launch logs, records and summaries agree between the two packages.

Each request joins a ``(model_id, method, n_pad, nx)`` bucket (time axis
padded to the next power of two; ``model_id``/``method`` are the tenant
dimension, so requests against different models or linearizations never
share a launch), and a bucket is flushed when any of

  * **full**     — it reached ``max_batch`` lanes (both policies);
  * **deadline** — waiting any longer would make the *tightest* deadline
                   in the bucket miss, given the predicted compute time
                   of the bucket (``min deadline - slack * est``);
  * **max_wait** — the oldest request has waited ``max_wait`` seconds
                   (starvation bound: rare signatures flush too);

fires. ``kind="static"`` disables the two timer conditions (fill-only).

When several buckets are due at one instant, launch order on the serial
executor is SLO-aware: timer-triggered flushes run before fill-triggered
ones, and ties break on the bucket's most urgent request priority
(`SLOClass.priority`; lower = more urgent). Flushes from one bucket keep
FIFO order.

Compute-time prediction is a per-signature EMA of measured bucket wall
times (`ComputeEstimator`), seeded by server warmup and scaled linearly
in batch width for unseen widths. Flush widths are quantized to powers
of two (`pad_width`), so each time bucket sees O(log2 max_batch) launch
shapes.

`run_service` is the discrete-event simulation: arrivals carry *simulated*
timestamps (reproducible, independent of host speed), while bucket
compute is *measured* wall time fed back by the executor callback. A
single serial executor models the one-card deployment: flushed buckets
queue behind one another (``free_at``).

The module is free of torch: policy logic is plain Python + numpy, unit
tested with a fake clock.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Signature = Tuple[str, str, int, int]  # (model_id, method, n_pad, nx)

FLUSH_FULL = "full"
FLUSH_DEADLINE = "deadline"
FLUSH_MAX_WAIT = "max_wait"
FLUSH_DRAIN = "drain"

#: Per-request verdict vocabulary. Executors report
#: ``ok``/``failed``/``retried``/``diverged`` per request; `run_service`
#: turns ``failed`` into one bounded re-enqueue through the retry lane
#: (or ``diverged`` when retries are exhausted/unavailable) and stamps
#: ``shed`` on batch-class flushes dropped under overload. Every record
#: a service returns carries exactly one of ok/retried/diverged/shed.
VERDICT_OK = "ok"
VERDICT_RETRIED = "retried"
VERDICT_FAILED = "failed"
VERDICT_DIVERGED = "diverged"
VERDICT_SHED = "shed"

# Launch-order rank when multiple buckets are due at one instant:
# timer-triggered flushes (a deadline or starvation bound is firing)
# beat fill-triggered ones; drain is the end-of-stream sweep.
_REASON_RANK = {FLUSH_DEADLINE: 0, FLUSH_MAX_WAIT: 0, FLUSH_FULL: 1,
                FLUSH_DRAIN: 2}


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def pad_width(k: int, max_batch: int) -> int:
    """Batch padding width for ``k`` requests: next power of two, clamped
    to ``max_batch``. THE width quantization — both the streaming queue
    (`FlushPolicy.pad_width`) and the one-shot server
    (`serve.SmootherServer.serve_requests`) route through this function,
    so the launch-shape space is O(log2 max_batch) per time bucket and
    cannot drift between serving paths or tenants."""
    return min(next_pow2(max(k, 1)), max_batch)


def bucket_signature(model_id: str, method: str, n: int, nx: int
                     ) -> Signature:
    """THE bucket key: ``(model_id, method, next_pow2(n), nx)``. Shared
    by `QueuedRequest.signature`, the one-shot server bucketing, and
    warmup — the single key-construction path."""
    return (str(model_id), str(method), next_pow2(n), int(nx))


def spec_signature(spec, n: int, nx: int) -> Signature:
    """Bucket key for a `repro_torch.core.SmootherSpec`-built server.

    The tenant slot carries ``spec.spec_id`` — the stable content hash
    over EVERY spec axis (model_id, linearization, form, iteration
    knobs, ...) — so any semantically meaningful change re-keys the
    bucket space and the autotune cache with it; the legacy ``method``
    slot stays for tuple-shape compatibility. Duck-typed (reads
    ``.spec_id`` and ``.method``) to keep this module free of torch.
    """
    return bucket_signature(spec.spec_id, spec.method, n, nx)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One priority/SLO tier: launch priority (lower = more urgent) and
    the default per-request completion budget."""

    name: str
    priority: int
    deadline_s: float


#: The serving tiers. ``batch`` has no deadline — only
#: the ``max_wait`` starvation bound flushes its buckets under load.
SLO_CLASSES = {
    "gold": SLOClass("gold", priority=0, deadline_s=0.5),
    "standard": SLOClass("standard", priority=1, deadline_s=2.0),
    "batch": SLOClass("batch", priority=2, deadline_s=math.inf),
}


@dataclasses.dataclass(frozen=True)
class QueuedRequest:
    """One smoothing request as the queue sees it.

    ``payload`` (the measurements) is opaque to the queue — policy
    decisions use only the bucket signature fields, arrival time,
    deadline, and priority. ``deadline`` is the *absolute* completion
    target in simulated seconds (``math.inf`` = none). ``tenant`` is a
    label for per-tenant accounting only; routing isolation comes from
    ``model_id``/``method`` being part of the signature. ``attempt``
    counts retry hops: `run_service` re-enqueues a failed request at most
    once (attempt 1, usually re-routed to a stronger-damped retry
    spec), keeping the original arrival/deadline so latency and
    deadline accounting stay end-to-end.
    """

    req_id: int
    n: int
    nx: int
    arrival: float
    deadline: float = math.inf
    payload: object = None
    model_id: str = ""
    method: str = "ekf"
    tenant: str = ""
    priority: int = SLO_CLASSES["standard"].priority
    attempt: int = 0

    @property
    def signature(self) -> Signature:
        return bucket_signature(self.model_id, self.method, self.n,
                                self.nx)


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """Knobs of the flush decision."""

    kind: str = "deadline"    # "deadline" | "static" (fill-only baseline)
    max_batch: int = 64       # bucket launch width (full-flush trigger)
    max_wait: float = 0.25    # s; queue-wait cap on the oldest request
    slack: float = 1.25       # safety factor on predicted compute time
    ema_alpha: float = 0.4    # compute-estimator smoothing
    default_compute: float = 0.0  # estimate before any observation
    #: Overload shedding: a flush whose every request is
    #: at ``shed_priority`` or lower urgency is dropped (verdict "shed")
    #: instead of executed when the serial executor's backlog at flush
    #: time exceeds ``shed_backlog_s`` seconds. ``inf`` disables.
    shed_backlog_s: float = math.inf
    shed_priority: int = SLO_CLASSES["batch"].priority

    def __post_init__(self):
        if self.kind not in ("deadline", "static"):
            raise ValueError(f"unknown flush policy kind {self.kind!r}")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.shed_backlog_s < 0.0:
            raise ValueError("shed_backlog_s must be >= 0")

    def pad_width(self, k: int) -> int:
        """Batch padding width for ``k`` requests (the shared module-level
        `pad_width` quantization, bound to this policy's ``max_batch``)."""
        return pad_width(k, self.max_batch)


class ComputeEstimator:
    """EMA of measured bucket compute seconds per (signature, b_pad).

    Unseen widths of a seen signature are scaled linearly in batch
    width from the nearest observed width (batched launch cost is
    ~linear in B on a fixed machine); fully unseen signatures fall back
    to ``default``.
    """

    def __init__(self, alpha: float = 0.4, default: float = 0.0):
        self.alpha = float(alpha)
        self.default = float(default)
        self._ema: Dict[Tuple[Signature, int], float] = {}
        #: Keys whose only observation is a cold (possibly compiling or
        #: kernel-building) first launch: kept as a provisional estimate
        #: but *replaced* — not blended — by the next observation, so one
        #: poisoned timing can't skew deadline decisions until the EMA
        #: decays.
        self._cold: set = set()

    def observe(self, sig: Signature, b_pad: int, dt: float,
                warmed: bool = False) -> None:
        """Record a measured launch. ``warmed=True`` marks a trustworthy
        post-warmup timing (server warmup measures one): it seeds the
        EMA directly. An unmarked *first* observation per key is treated
        as cold — held provisionally, then discarded when the next
        observation arrives (the first real launch of a shape pays
        one-time set-up, often orders of magnitude above steady state).
        """
        key = (sig, int(b_pad))
        old = self._ema.get(key)
        if old is None:
            self._ema[key] = float(dt)
            if not warmed:
                self._cold.add(key)
            return
        if key in self._cold:
            # Second observation: drop the poisoned cold seed entirely.
            self._cold.discard(key)
            self._ema[key] = float(dt)
            return
        self._ema[key] = self.alpha * float(dt) + (1.0 - self.alpha) * old

    def estimate(self, sig: Signature, b_pad: int) -> float:
        key = (sig, int(b_pad))
        if key in self._ema:
            return self._ema[key]
        widths = [w for (s, w) in self._ema if s == sig]
        if widths:
            # Tie-break equidistant widths toward the *larger* one
            # (deterministic regardless of observation order, and the
            # larger width's per-element cost is the safer deadline
            # bound — amortized overheads make small-B timings optimistic
            # when scaled up).
            w = min(widths, key=lambda w: (abs(w - b_pad), -w))
            return self._ema[(sig, w)] * (b_pad / w)
        return self.default


@dataclasses.dataclass
class BucketFlush:
    """One launch decision: which requests, at what padded width, why.
    ``priority`` is the most urgent request priority in the flush
    (launch-order tiebreak on the serial executor)."""

    signature: Signature
    requests: List[QueuedRequest]
    b_pad: int
    reason: str
    at: float
    priority: int = SLO_CLASSES["standard"].priority


class AutobatchQueue:
    """Deadline-aware bucket queue over ``(n_pad, nx)`` signatures.

    Clock-agnostic: callers pass ``now`` explicitly (simulated seconds in
    the service loop, fabricated values in the fake-clock unit tests).
    """

    def __init__(self, policy: FlushPolicy,
                 estimator: Optional[ComputeEstimator] = None):
        self.policy = policy
        self.estimator = estimator if estimator is not None else \
            ComputeEstimator(policy.ema_alpha, policy.default_compute)
        self._buckets: Dict[Signature, deque] = {}

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def pending(self) -> int:
        return len(self)

    def submit(self, req: QueuedRequest, now: float) -> None:
        del now  # admission is unconditional; kept for symmetry
        self._buckets.setdefault(req.signature, deque()).append(req)

    def _due(self, sig: Signature) -> Tuple[float, str]:
        """Earliest time this bucket must flush, and the triggering rule.

        The deadline bound scans the whole bucket — deadlines are an
        arbitrary per-request field, so the tightest one need not belong
        to the FIFO head. Static policy never times out (fill-only):
        due is ``inf``.
        """
        bucket = self._buckets[sig]
        if not bucket or self.policy.kind == "static":
            return math.inf, FLUSH_DRAIN
        b_pad = self.policy.pad_width(len(bucket))
        est = self.estimator.estimate(sig, b_pad)
        tightest = min(r.deadline for r in bucket)
        due_deadline = tightest - self.policy.slack * est
        due_wait = bucket[0].arrival + self.policy.max_wait
        if due_deadline <= due_wait:
            return due_deadline, FLUSH_DEADLINE
        return due_wait, FLUSH_MAX_WAIT

    def next_due(self) -> float:
        """Earliest timer-driven flush instant across buckets (inf if
        none) — the service loop's next wake-up."""
        dues = [self._due(sig)[0] for sig in self._buckets]
        return min(dues) if dues else math.inf

    def _pop_chunk(self, sig: Signature, k: int, reason: str, now: float
                   ) -> BucketFlush:
        bucket = self._buckets[sig]
        reqs = [bucket.popleft() for _ in range(min(k, len(bucket)))]
        return BucketFlush(signature=sig, requests=reqs,
                           b_pad=self.policy.pad_width(len(reqs)),
                           reason=reason, at=now,
                           priority=min(r.priority for r in reqs))

    def pop_ready(self, now: float, drain: bool = False
                  ) -> List[BucketFlush]:
        """All flushes triggered at ``now``, in SLO-aware launch order:
        buckets with a timer-triggered flush (deadline/max-wait) come
        before fill-only buckets, ties break on the bucket's most urgent
        request priority, then signature (determinism). FIFO holds
        inside a bucket — urgency is ranked per bucket, so a bucket's
        older full chunk is never reordered behind its newer remainder.
        With ``drain=True`` every remaining request flushes (end of
        stream)."""
        groups: List[Tuple[Tuple[int, int, Signature], List[BucketFlush]]] \
            = []
        for sig in sorted(self._buckets):
            bucket = self._buckets[sig]
            popped: List[BucketFlush] = []
            while len(bucket) >= self.policy.max_batch:
                popped.append(self._pop_chunk(
                    sig, self.policy.max_batch, FLUSH_FULL, now))
            if bucket:
                due, rule = self._due(sig)
                if due <= now:
                    popped.append(self._pop_chunk(sig, len(bucket), rule,
                                                  now))
                elif drain:
                    popped.append(self._pop_chunk(
                        sig, len(bucket), FLUSH_DRAIN, now))
            if popped:
                rank = min(_REASON_RANK[f.reason] for f in popped)
                prio = min(f.priority for f in popped)
                groups.append(((rank, prio, sig), popped))
        groups.sort(key=lambda g: g[0])
        return [f for _, popped in groups for f in popped]


# ---------------------------------------------------------------------------
# Discrete-event service loop
# ---------------------------------------------------------------------------

def make_arrivals(kind: str, n_requests: int, rate: float,
                  burst_size: int = 8, seed: int = 0) -> np.ndarray:
    """Simulated arrival timestamps (seconds, sorted, length n_requests).

    ``poisson`` — exponential inter-arrival times at ``rate`` req/s.
    ``bursty``  — bursts of ``burst_size`` back-to-back requests; burst
    *starts* are Poisson at ``rate / burst_size`` so the offered load
    (requests/s) matches the poisson setting at equal ``rate``.
    """
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        gaps = rng.exponential(1.0 / rate, n_requests)
        return np.cumsum(gaps)
    if kind == "bursty":
        n_bursts = math.ceil(n_requests / burst_size)
        starts = np.cumsum(rng.exponential(burst_size / rate, n_bursts))
        times = np.repeat(starts, burst_size)[:n_requests]
        return times
    raise ValueError(f"unknown arrival process {kind!r}")


def run_service(requests: Sequence[QueuedRequest],
                execute: Callable[[BucketFlush], object],
                policy: FlushPolicy,
                estimator: Optional[ComputeEstimator] = None,
                *,
                retry: Optional[Callable[[QueuedRequest],
                                         Optional[QueuedRequest]]] = None,
                watchdog=None,
                absorb: Tuple[type, ...] = (Exception,)) -> dict:
    """Drive the queue over a timestamped request stream.

    ``execute(flush)`` runs the padded bucket and returns either its
    measured wall seconds (every request succeeded) or a ``(seconds,
    outcomes)`` pair where ``outcomes`` maps ``req_id`` to a verdict
    (`VERDICT_OK`/`VERDICT_RETRIED`/`VERDICT_FAILED`/`VERDICT_DIVERGED`;
    missing ids default to ok). It charges compute to a single
    serial executor (compute is real, the clock between events is
    simulated) and keeps the faults it absorbs inside the queue:

      * ``failed`` requests on their first attempt are re-enqueued once
        through ``retry(request) -> QueuedRequest`` (typically re-routed
        to a stronger-damped spec; original arrival/deadline preserved);
        without a retry hook — or on a repeat failure — the verdict is
        ``diverged``;
      * an exception raised by ``execute`` marks the whole flush failed
        (same retry path) and is recorded on the launch, not raised —
        if it is an instance of ``absorb`` (default: any exception, as
        in the JAX package); anything else propagates;
      * flushes whose most urgent request is at
        ``policy.shed_priority`` or below are dropped with verdict
        ``shed`` when the executor backlog exceeds
        ``policy.shed_backlog_s`` at flush time (overload shedding);
      * ``watchdog`` (a `repro_torch.runtime.StepWatchdog`) observes each
        launch's measured compute; straggler-flagged launches are marked
        in the log and — like failed ones — kept out of the
        `ComputeEstimator` EMA, so one outlier poisons neither the
        anomaly baseline nor the flush-timing predictions.

    Returns per-request records (each with a ``verdict``) plus launch
    log; summarize with `summarize_service`.
    """
    queue = AutobatchQueue(policy, estimator)
    events = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    i, n = 0, len(events)
    clock = 0.0
    free_at = 0.0
    records: List[dict] = []
    launches: List[dict] = []

    def record(r: QueuedRequest, verdict: str, done: float, start: float,
               dt: float, reason: str) -> None:
        records.append({
            "req_id": r.req_id, "arrival": r.arrival,
            "latency_s": done - r.arrival,
            "queue_wait_s": start - r.arrival,
            "compute_s": dt, "reason": reason,
            "deadline_met": (verdict != VERDICT_SHED
                             and done <= r.deadline),
            "tenant": r.tenant, "verdict": verdict,
            "attempt": r.attempt,
        })

    def run_flushes(flushes: List[BucketFlush]) -> None:
        nonlocal free_at
        for fl in flushes:
            backlog = max(0.0, free_at - fl.at)
            if (fl.priority >= policy.shed_priority
                    and backlog > policy.shed_backlog_s):
                launches.append({
                    "signature": fl.signature, "b": len(fl.requests),
                    "b_pad": fl.b_pad, "reason": fl.reason, "at": fl.at,
                    "start": fl.at, "compute_s": 0.0,
                    "priority": fl.priority, "shed": True,
                    "req_ids": [r.req_id for r in fl.requests],
                    "tenants": sorted({r.tenant for r in fl.requests}),
                })
                for r in fl.requests:
                    record(r, VERDICT_SHED, fl.at, fl.at, 0.0, fl.reason)
                continue
            start = max(fl.at, free_at)
            error = None
            try:
                res = execute(fl)
            except absorb as e:  # the fault boundary
                error = f"{type(e).__name__}: {e}"
                res = (0.0, {r.req_id: VERDICT_FAILED
                             for r in fl.requests})
            if isinstance(res, tuple):
                dt, outcomes = float(res[0]), dict(res[1])
            else:
                dt, outcomes = float(res), {}
            done = start + dt
            free_at = done
            report = (watchdog.observe(step=len(launches), duration=dt)
                      if watchdog is not None and error is None else None)
            if error is None and report is None:
                # Only clean, non-straggler launches feed the EMA.
                queue.estimator.observe(fl.signature, fl.b_pad, dt)
            launches.append({
                "signature": fl.signature, "b": len(fl.requests),
                "b_pad": fl.b_pad, "reason": fl.reason, "at": fl.at,
                "start": start, "compute_s": dt,
                "priority": fl.priority,
                "req_ids": [r.req_id for r in fl.requests],
                "tenants": sorted({r.tenant for r in fl.requests}),
                **({"error": error} if error else {}),
                **({"straggler": True} if report is not None else {}),
            })
            for r in fl.requests:
                verdict = outcomes.get(r.req_id, VERDICT_OK)
                if verdict == VERDICT_OK and r.attempt > 0:
                    verdict = VERDICT_RETRIED
                if verdict == VERDICT_FAILED:
                    rq = (retry(r) if retry is not None
                          and r.attempt == 0 else None)
                    if rq is not None:
                        # One bounded retry hop; the final record comes
                        # from the retry flush.
                        queue.submit(rq, done)
                        continue
                    verdict = VERDICT_DIVERGED
                record(r, verdict, done, start, dt, fl.reason)

    while i < n or queue.pending():
        next_arr = events[i].arrival if i < n else math.inf
        due = queue.next_due()
        if next_arr <= due:
            if next_arr == math.inf:
                # Stream over, no timers pending: drain (static policy).
                run_flushes(queue.pop_ready(clock, drain=True))
                continue
            clock = max(clock, next_arr)
            while i < n and events[i].arrival <= clock:
                queue.submit(events[i], clock)
                i += 1
        else:
            clock = max(clock, due)
        run_flushes(queue.pop_ready(clock))

    return {"records": records, "launches": launches}


def _latency_digest(records: Sequence[dict]) -> dict:
    lat = np.asarray([r["latency_s"] for r in records])
    wait = np.asarray([r["queue_wait_s"] for r in records])
    return {
        "requests": len(records),
        "latency_p50_s": float(np.percentile(lat, 50)) if len(lat) else 0.0,
        "latency_p95_s": float(np.percentile(lat, 95)) if len(lat) else 0.0,
        "latency_mean_s": float(lat.mean()) if len(lat) else 0.0,
        "queue_wait_p95_s": (float(np.percentile(wait, 95))
                             if len(wait) else 0.0),
        "deadline_hit_rate": (float(np.mean([r["deadline_met"]
                                             for r in records]))
                              if len(records) else 1.0),
    }


def summarize_service(service: dict) -> dict:
    """Latency/throughput digest of a `run_service` result.

    When the request stream is multi-tenant (records carry more than one
    distinct ``tenant`` label), a ``per_tenant`` dict of sub-digests —
    per-tenant p50/p95 latency and deadline-hit rate — rides along with
    the global numbers. Latency percentiles cover completed requests
    only (shed ones never ran); the health side reports per-verdict
    counts, straggler-flagged launch count, and ``goodput_rps`` — the
    rate of requests that both produced a healthy answer (verdict
    ok/retried) and met their deadline, the robustness headline the
    chaos runs track.
    """
    records, launches = service["records"], service["launches"]
    completed = [r for r in records
                 if r.get("verdict", VERDICT_OK) != VERDICT_SHED]
    lat = np.asarray([r["latency_s"] for r in completed])
    arrivals = np.asarray([r["arrival"] for r in records])
    done = np.asarray([r["arrival"] + r["latency_s"] for r in records])
    span = float(done.max() - arrivals.min()) if len(records) else 0.0
    reasons: Dict[str, int] = {}
    for l in launches:
        reasons[l["reason"]] = reasons.get(l["reason"], 0) + 1
    verdicts: Dict[str, int] = {}
    for r in records:
        v = r.get("verdict", VERDICT_OK)
        verdicts[v] = verdicts.get(v, 0) + 1
    good = sum(1 for r in records
               if r.get("verdict", VERDICT_OK) in (VERDICT_OK,
                                                   VERDICT_RETRIED)
               and r["deadline_met"])
    executed = [l for l in launches if not l.get("shed")]
    occupancy = (float(np.mean([l["b"] / l["b_pad"] for l in executed]))
                 if executed else 0.0)
    out = {
        **_latency_digest(completed),
        "requests": len(records),
        "launches": len(launches),
        "traj_per_s": len(records) / span if span > 0 else 0.0,
        "goodput_rps": good / span if span > 0 else 0.0,
        "occupancy": occupancy,
        "flush_reasons": reasons,
        "verdicts": verdicts,
        "stragglers": sum(1 for l in launches if l.get("straggler")),
    }
    tenants = sorted({r.get("tenant", "") for r in records})
    if len(tenants) > 1:
        out["per_tenant"] = {
            t: _latency_digest([r for r in records
                                if r.get("tenant", "") == t])
            for t in tenants}
    return out
