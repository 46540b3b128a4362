"""Serving driver: two workloads behind one CLI, as in the JAX package.

``decode`` — batched LM decoding with KV caches or recurrent state (the
dense, hybrid, MoE, xLSTM and encoder-decoder families): the prompt
teacher-forced through `decode_step`, then greedy steps; attention runs
the CUDA kernels on the card (the split-K decode kernel on the cache in
place, a sliding-window layer's cache a ring, grok's logit softcap inside
the kernel, in every layer of every step; a hybrid block's SSM step is
elementwise; an MoE block dispatches the step's tokens to its experts by
the reference's sort-based capacity dispatch, with no host sync; an
xLSTM block updates its fixed-size state in place; an encoder-decoder
decoder layer also attends to the encoder memory, through the split-K
decode kernel):

    python -m repro_torch.launch.serve --workload decode --arch qwen2-1.5b \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    python -m repro_torch.launch.serve --workload decode --arch hymba-1.5b \
        --device cpu
    python -m repro_torch.launch.serve --workload decode \
        --arch deepseek-moe-16b|grok-1-314b|xlstm-350m|seamless-m4t-medium \
        --device cpu

As in the reference, ``--reduced`` cannot be turned off: the CLI serves
the reduced config, and the full width is ``ServeConfig(reduced=False)``.

``smoother`` — the state-estimation service below.

Smoother service: batched state estimation of many trajectories at once.

A fleet of smoothing requests with heterogeneous trajectory lengths is
bucketed by ``(spec_id, method, next_pow2(n), nx)``, padded along time
with uninformative measurements (R inflated by ``R_PAD_SCALE``, so padded
steps carry no information) and along batch by replicating lane 0 up to a
power-of-two width, then each bucket runs as ONE batched iterated
smoother call — B trajectories per combine launch of every scan level.

Two serving modes, as in the JAX package:

* ``--arrival none`` — one shot: all requests are present up front and
  buckets launch back to back;
* ``--arrival poisson|bursty`` — a timestamped request stream driven
  through the autobatching queue (`launch/autobatch.py`): ``--policy
  deadline`` flushes buckets under per-request latency deadlines,
  ``--policy static`` only when they fill. A request whose lane diverges
  is retried once on an adaptive-damping lane, then on a sequential
  fallback; ``--chaos RATE`` injects NaN payloads, transient exceptions
  and stragglers (`launch/chaos.py`).

    python -m repro_torch.launch.serve --workload smoother --requests 64 \
        --n 512 --max-batch 64 --arrival poisson --policy deadline

``--tenants coordinated_turn,pendulum:gold,lorenz96:batch`` serves a mixed
stream of registry scenarios through one queue, each tenant with its own
server, spec and SLO class, and breaks latency down per tenant.

Everything runs on the card (``--device cpu`` runs the plain PyTorch path
on the CPU). Under ``backend="auto"`` (the default) a bucket shape that
the server's warmup measured runs the winner of the CUDA combine kernels
and their plain versions (`kernels/kalman_combine/autotune.py`); a shape
nothing measured — the one-shot path's, the retry lane's — runs the
kernels. An executor exception that chaos did not inject is raised, not
turned into retried requests.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import SmootherSpec, build_smoother
from repro_torch.core.iterated import LANE_DIVERGED
from repro_torch.core.types import Device, StateSpaceModel, resolve_device
from repro_torch.launch.autobatch import (SLO_CLASSES, VERDICT_DIVERGED,
                                          VERDICT_FAILED, VERDICT_OK,
                                          VERDICT_RETRIED, ComputeEstimator,
                                          FlushPolicy, QueuedRequest,
                                          make_arrivals, pad_width,
                                          run_service, spec_signature,
                                          summarize_service)
from repro_torch.launch.chaos import (ChaosConfig, ChaosInjector,
                                      TransientComputeError)
from repro_torch.runtime import StepWatchdog, with_retries

# ---------------------------------------------------------------------------
# Decode workload (LM serving)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeConfig:
    arch: str
    batch: int = 4
    prompt_len: int = 32
    gen: int = 16
    max_len: int = 128
    reduced: bool = True
    seed: int = 0
    greedy: bool = True
    temperature: float = 1.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cfg, prompts: torch.Tensor, gen: int,
             max_len: int, memory: Optional[torch.Tensor] = None) -> dict:
    """The reference service's loop on given weights and prompts: caches
    of capacity ``max_len``, the prompt ``[B, P]`` teacher-forced through
    `decode_step` one position at a time, then ``gen`` greedy steps (argmax
    over the real vocabulary); an encoder-decoder model's steps attend to
    the encoder ``memory [B, S, d]``. Returns ``tokens [B, gen]`` (int32,
    on the prompts' device), the last step's ``logits [B, 1, padded_vocab]``
    (position ``P + gen - 1``), the wall ``seconds`` of the ``P + gen``
    steps and ``tok_per_s``. Nothing waits on the host between steps."""
    from repro_torch.models import decode_step, init_caches

    B, P = prompts.shape
    device = prompts.device
    caches = init_caches(cfg, B, max_len, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for i in range(P):
        logits, caches = decode_step(model, cfg, caches, prompts[:, i:i + 1],
                                     i, memory)
    generated = []
    tok = logits[:, :, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    for j in range(gen):
        generated.append(tok)
        logits, caches = decode_step(model, cfg, caches, tok, P + j, memory)
        tok = logits[:, :, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    _sync(device)
    dt = time.perf_counter() - t0
    tokens = torch.cat(generated, dim=1) if generated else \
        prompts.new_zeros((B, 0), dtype=torch.int32)
    return {"tokens": tokens, "logits": logits, "seconds": dt,
            "tok_per_s": B * (P + gen) / dt}


def serve(serve_cfg: ServeConfig, emit=print, *, device: Device = None
          ) -> dict:
    """The reference's decode service: random weights from
    ``serve_cfg.seed``, prompts drawn from a generator seeded
    ``seed + 1`` (torch's stream, so the ids differ from JAX's), run by
    `generate`, on ``device`` (the card unless ``device="cpu"``). An
    encoder-decoder config encodes a zero ``[B, encoder_seq_len, d_model]``
    float32 frontend once, before the timed loop, as the reference does.
    That memory is exactly zero (without QKV biases every block maps 0 to
    0, and so does ``enc_norm``), so every cross-attention output of the
    service is exactly zero too."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import encode, init_model

    device = resolve_device(device)
    cfg = get_config(serve_cfg.arch)
    if serve_cfg.reduced:
        cfg = reduced_config(cfg)
    model = init_model(cfg, serve_cfg.seed, device=device)
    B = serve_cfg.batch
    gen = torch.Generator(device=device).manual_seed(serve_cfg.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, serve_cfg.prompt_len),
                            generator=gen, device=device)
    memory = None
    if cfg.encoder_layers:
        memory = encode(model, cfg, torch.zeros(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=torch.float32,
            device=device))
    out = generate(model, cfg, prompts, serve_cfg.gen, serve_cfg.max_len,
                   memory)
    total = serve_cfg.prompt_len + serve_cfg.gen
    emit(f"[serve] {B} seqs x {total} steps in {out['seconds']:.2f}s "
         f"({out['tok_per_s']:.1f} tok/s)")
    return out


# ---------------------------------------------------------------------------
# Smoother workload (batched state-estimation service)
# ---------------------------------------------------------------------------

R_PAD_SCALE = 1e8  # measurement-noise inflation on padded time steps


def _backend_choices() -> Dict[str, str]:
    """The autotuner's measured combine verdicts so far, keyed
    ``spec_id@platform/B=../T=../nx=..`` — reported in the stream stats,
    so an operator sees which buckets run the kernels."""
    from repro_torch.kernels.kalman_combine import autotune as kc_autotune

    return {k: v["choice"] for k, v in kc_autotune.cache_entries().items()}


@dataclasses.dataclass
class SmootherServeConfig:
    requests: int = 64
    n: int = 512             # maximum trajectory length in the request mix
    max_batch: int = 64      # bucket launch width
    method: str = "ekf"      # "ekf" (IEKS, Taylor) | "slr" (IPLS, cubature)
    n_iter: int = 10
    tol: float = 1e-6        # 0 disables early stopping
    parallel: bool = True
    lm_lambda: float = 1.0   # damping; undamped GN diverges on long tracks
    vary_lengths: bool = True
    seed: int = 0
    f64: bool = True         # covariance form is f32-fragile at long n
    # Streaming mode (autobatch queue; "none" = one-shot path).
    arrival: str = "none"    # "none" | "poisson" | "bursty"
    policy: str = "static"   # "static" | "deadline"
    rate: float = 8.0        # offered load, requests/s (simulated clock)
    burst_size: int = 8      # bursty: requests per burst
    deadline_s: float = 2.0  # per-request completion budget
    max_wait_s: float = 0.25  # queue-wait cap (starvation bound)
    slack: float = 1.25      # safety factor on predicted compute
    warm: bool = True        # warm every bucket shape before serving
    # Fault injection (streaming mode only; see launch/chaos.py).
    chaos_rate: float = 0.0  # headline rate for ChaosConfig.at_rate
    chaos_seed: int = 0

    def chaos_config(self) -> Optional[ChaosConfig]:
        """The `ChaosConfig` for ``chaos_rate`` (None when disabled)."""
        if self.chaos_rate <= 0:
            return None
        return ChaosConfig.at_rate(self.chaos_rate, seed=self.chaos_seed)


def pad_requests(batch: List[torch.Tensor], n_pad: int, b_pad: int,
                 R: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a bucket of measurement sequences to ``[b_pad, n_pad, ny]``.

    Time padding appends zero measurements whose per-step R is inflated
    by ``R_PAD_SCALE`` (an uninformative update up to float error); batch
    padding replicates lane 0. Returns the padded measurements and the
    per-lane, per-step R stack, on ``R``'s device.
    """
    ny = R.shape[-1]
    ys = torch.zeros((b_pad, n_pad, ny), dtype=R.dtype, device=R.device)
    rs = (R * R_PAD_SCALE).expand(b_pad, n_pad, ny, ny).clone()
    for i, y in enumerate(batch):
        y = torch.as_tensor(y, dtype=R.dtype, device=R.device)
        ys[i, :len(y)] = y
        rs[i, :len(y)] = R
    if len(batch) < b_pad:                        # batch padding: replicate
        ys[len(batch):] = ys[0]
        rs[len(batch):] = rs[0]
    return ys, rs


class SmootherServer:
    """Bucketed batched smoothing service over one state-space model.

    Requests (``ys [n_i, ny]`` tensors) are grouped by
    `autobatch.spec_signature`; inside a bucket the time axis is padded
    to the bucket length and the batch axis to a power-of-two launch width
    (`pad_requests`). The smoother is ``build_smoother(spec,
    device=device)``; with no ``spec`` it is built from the
    `SmootherServeConfig` knobs. Beside it live the bounded-retry lane
    (the same spec with adaptive damping and ``lm_lambda >= 10``) and the
    sequential fallback (adaptive, standard form, one trajectory at a
    time).
    """

    def __init__(self, model: StateSpaceModel, cfg: SmootherServeConfig,
                 spec: Optional[SmootherSpec] = None, device: Device = None,
                 tenant: str = ""):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, server runs "
                             f"on {self.device}")
        self.model = model
        self.cfg = cfg
        self.tenant = tenant
        if spec is None:
            spec = SmootherSpec(
                mode="parallel" if cfg.parallel else "sequential",
                linearization=("taylor" if cfg.method == "ekf"
                               else "slr"),
                n_iter=cfg.n_iter, tol=cfg.tol, lm_lambda=cfg.lm_lambda)
        self.spec = spec
        self._smoother = build_smoother(spec, device=self.device)
        self._icfg = self._smoother.config   # model_id == spec.spec_id
        # The bounded-retry lane: same spec with adaptive per-lane LM
        # damping and a stronger initial lambda. Its distinct spec_id
        # routes retried requests to their own buckets.
        retry_spec = dataclasses.replace(
            spec, damping="adaptive",
            lm_lambda=max(spec.lm_lambda * 10.0, 10.0))
        self._retry_smoother = build_smoother(retry_spec, device=self.device)
        # Second-failure fallback: the sequential adaptive smoother, run
        # per trajectory. Square-root factors exist only for the parallel
        # combines, so the form drops to the standard covariance form.
        fallback_spec = dataclasses.replace(
            retry_spec, mode="sequential", form="standard")
        self._fallback_smoother = build_smoother(fallback_spec,
                                                 device=self.device)
        #: Bucket launch signatures seen so far (warmup bookkeeping).
        self.signatures_seen = set()

    @property
    def icfg(self):
        return self._icfg

    @property
    def model_id(self) -> str:
        """The server's routing identity: the spec's content hash."""
        return self._icfg.model_id

    @property
    def retry_model_id(self) -> str:
        """Routing identity of the bounded-retry lane: requests
        re-enqueued after a lane failure carry it, so the queue buckets
        them apart from healthy traffic."""
        return self._retry_smoother.config.model_id

    def queue_signature(self, n: int):
        """The bucket key for a request of length ``n``."""
        return spec_signature(self.spec, n, self.model.nx)

    def _run(self, smoother, ys: torch.Tensor, r_stack: torch.Tensor):
        model_b = dataclasses.replace(self.model, R=r_stack)
        traj, info = smoother.iterate(model_b, ys, return_info=True)
        # Per-step fit scores; padded steps are masked by the caller
        # (their inflated-R terms belong to no request).
        ll_steps = smoother.log_likelihood(model_b, ys, traj, per_step=True)
        return traj, info, ll_steps

    def smooth_batch(self, batch: List[torch.Tensor], n_pad: int,
                     b_pad: int, lane: str = "primary"):
        """Run one padded bucket launch. Returns per-request smoothed
        means (``[n_i + 1, nx]`` tensors), the per-lane `LaneStatus`,
        per-request log-likelihood fit scores over real steps only, and
        per-request health (finite posterior, not `LANE_DIVERGED`).

        ``lane`` selects the smoother: ``"primary"`` is the server's spec,
        ``"retry"`` the adaptive-damping bounded-retry spec. Returns after
        the device has finished (the health list is read back)."""
        smoother = (self._smoother if lane == "primary"
                    else self._retry_smoother)
        self.signatures_seen.add(
            smoother.config.cache_key(n_pad, b_pad, self.model.nx))
        ys, rs = pad_requests(batch, n_pad, b_pad, self.model.R)
        traj, info, ll_steps = self._run(smoother, ys, rs)
        lengths = [len(y) for y in batch]
        means = [traj.mean[i, :L + 1] for i, L in enumerate(lengths)]
        steps = torch.arange(n_pad, device=ll_steps.device)
        real = steps[None, :] < torch.tensor(lengths,
                                             device=ll_steps.device)[:, None]
        ll = torch.where(real, ll_steps[:len(batch)], 0.0).sum(dim=1)
        finite = torch.stack([torch.isfinite(m).all() for m in means])
        ok = finite & (info.code[:len(batch)] != LANE_DIVERGED)
        logliks = ll.tolist()
        health = ok.tolist()
        return means, info, logliks, health

    def _dummy(self, n_pad: int) -> torch.Tensor:
        return torch.zeros((n_pad, self.model.ny), dtype=self.model.R.dtype,
                           device=self.device)

    def warmup(self, n_pads, b_pads,
               estimator: Optional[ComputeEstimator] = None) -> None:
        """Warm every ``(n_pad, b_pad)`` bucket shape and, when an
        estimator is given, seed it with a warm measured launch each.

        Under ``backend="auto"`` each shape is autotuned first (kernel vs
        plain version, `Smoother.autotune`), so its launches take the
        measured winner. A shape already seen skips the warm call, and
        without an estimator (the static policy never consults one)
        nothing is re-measured — a shared server pays for each shape
        once, not per stream.
        """
        for n_pad in sorted(set(n_pads)):
            dummy = [self._dummy(n_pad)]
            for b_pad in sorted(set(b_pads)):
                if self.spec.backend == "auto":
                    self._smoother.autotune(b_pad, n_pad, self.model.nx)
                key = self._icfg.cache_key(n_pad, b_pad, self.model.nx)
                if key not in self.signatures_seen:
                    self.smooth_batch(dummy, n_pad, b_pad)
                if estimator is not None:
                    t0 = time.perf_counter()
                    _, info, _, _ = self.smooth_batch(dummy, n_pad, b_pad)
                    dt = time.perf_counter() - t0
                    # The zero-measurement dummy converges early under
                    # tol > 0; scale to the full pass budget so the seed
                    # upper-bounds real traffic.
                    iters = float(info.iterations.double().mean())
                    if self._icfg.tol > 0.0 and iters >= 1.0:
                        dt *= self._icfg.n_iter / iters
                    estimator.observe(self.queue_signature(n_pad), b_pad,
                                      dt, warmed=True)

    def warmup_retry(self, n_pads) -> None:
        """Warm the bounded-retry lane (widths 1 and 2 — retry buckets
        hold the rare failed requests) and the sequential fallback for the
        given bucket lengths, so injected faults measure the retry
        *policy*, not first-use costs."""
        for n_pad in sorted(set(n_pads)):
            dummy = self._dummy(n_pad)
            for b_pad in (1, 2):
                self.smooth_batch([dummy], n_pad, b_pad, lane="retry")
            self._fallback_single(dummy, n_pad)

    def retry_request(self, req: QueuedRequest) -> QueuedRequest:
        """The re-enqueue hook of `autobatch.run_service`: move a failed
        request onto the bounded-retry lane, bumping ``attempt``. Arrival
        and deadline are kept — a retry buys no SLO budget."""
        return dataclasses.replace(req, model_id=self.retry_model_id,
                                   attempt=req.attempt + 1)

    def _fallback_single(self, ys: torch.Tensor, n_pad: int):
        """Sequential adaptive smoothing of ONE trajectory — the last
        resort after the retry lane also failed. Returns ``(mean, loglik,
        healthy, passes)``; a still-diverged lane comes back frozen at its
        last finite iterate with ``healthy=False``."""
        ys_p, rs = pad_requests([ys], n_pad, 1, self.model.R)
        traj, info, ll_steps = self._run(self._fallback_smoother, ys_p, rs)
        mean = traj.mean[0, :len(ys) + 1]
        ll = float(ll_steps[0, :len(ys)].sum())
        code = int(info.code[0])
        healthy = (code != LANE_DIVERGED) and bool(torch.isfinite(mean).all())
        return mean, ll, healthy, int(info.iterations[0])

    def run_flush(self, fl):
        """Execute one queue flush with lane-health classification.

        Routes the flush to the primary or retry smoother by its
        signature, classifies every request by its lane's `LaneStatus`,
        and — for requests already on the retry lane that fail again —
        runs the sequential fallback inline. Returns ``(dt, outcomes,
        store, iters)``: measured wall seconds (ending after the device
        has finished), the per-request verdicts `run_service` consumes,
        the results to publish (``req_id -> (mean, loglik, passes)``; a
        failed attempt-0 entry holds the diverged lane's output and is
        overwritten when its retry completes), and total passes spent.
        """
        lane = ("retry" if fl.signature[0] == self.retry_model_id
                else "primary")
        batch = [r.payload for r in fl.requests]
        n_pad = fl.signature[2]
        t0 = time.perf_counter()
        means, info, lls, health = self.smooth_batch(
            batch, n_pad, fl.b_pad, lane=lane)
        passes = info.iterations[:len(batch)].tolist()
        outcomes, store = {}, {}
        for i, r in enumerate(fl.requests):
            if health[i]:
                outcomes[r.req_id] = (VERDICT_OK if r.attempt == 0
                                      else VERDICT_RETRIED)
                store[r.req_id] = (means[i], lls[i], passes[i])
            elif r.attempt == 0:
                # Withhold the diverged posterior; run_service re-enqueues
                # through retry_request (or degrades to diverged with no
                # retry hook installed — publish the frozen iterate).
                outcomes[r.req_id] = VERDICT_FAILED
                store[r.req_id] = (means[i], lls[i], passes[i])
            else:
                m, ll, ok, p = self._fallback_single(r.payload, n_pad)
                outcomes[r.req_id] = (VERDICT_RETRIED if ok
                                      else VERDICT_DIVERGED)
                store[r.req_id] = (m, ll, p)
        dt = time.perf_counter() - t0
        return dt, outcomes, store, int(sum(passes))

    def serve_requests(self, requests: List[torch.Tensor], emit=print
                       ) -> dict:
        """Bucket, pad, and smooth a full request list; returns stats."""
        buckets: Dict[tuple, List[int]] = defaultdict(list)
        for idx, ys in enumerate(requests):
            buckets[self.queue_signature(len(ys))].append(idx)

        results: List[Optional[torch.Tensor]] = [None] * len(requests)
        logliks: List[Optional[float]] = [None] * len(requests)
        codes: List[Optional[int]] = [None] * len(requests)
        iterations: List[Optional[int]] = [None] * len(requests)
        launches = 0
        t0 = time.perf_counter()
        for sig in sorted(buckets):
            n_pad = sig[2]
            idxs = buckets[sig]
            for lo in range(0, len(idxs), self.cfg.max_batch):
                chunk = idxs[lo:lo + self.cfg.max_batch]
                b_pad = pad_width(len(chunk), self.cfg.max_batch)
                means, info, lls, _ = self.smooth_batch(
                    [requests[i] for i in chunk], n_pad, b_pad)
                lane_codes = info.code[:len(chunk)].tolist()
                passes = info.iterations[:len(chunk)].tolist()
                for j, i in enumerate(chunk):
                    results[i], logliks[i] = means[j], lls[j]
                    codes[i], iterations[i] = lane_codes[j], passes[j]
                launches += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        stats = {
            "results": results,
            "logliks": logliks,
            "codes": codes,
            "iterations": iterations,
            "requests": len(requests),
            "launches": launches,
            "mean_iterations": sum(iterations) / max(len(requests), 1),
            "wall_s": dt,
            "traj_per_s": len(requests) / dt,
        }
        emit(f"[serve/smoother] {len(requests)} requests in {launches} "
             f"bucket launches, {dt:.2f}s ({stats['traj_per_s']:.1f} traj/s,"
             f" {stats['mean_iterations']:.1f} mean iters)")
        return stats

    def serve_stream(self, requests: List[torch.Tensor],
                     arrivals: np.ndarray, emit=print,
                     policy: Optional[FlushPolicy] = None,
                     chaos: Optional[ChaosConfig] = None) -> dict:
        """Serve a *timestamped* request stream through the autobatching
        queue (simulated arrival clock, measured bucket compute).

        Flush knobs default to the server config; pass an explicit
        `FlushPolicy` to sweep policies on one warm server. ``chaos``
        injects the seeded fault mix of `launch.chaos`: corrupted payloads
        go through the full retry/fallback pipeline, transient executor
        exceptions are absorbed in place by `with_retries`, and injected
        stragglers are flagged by the `StepWatchdog` without polluting the
        compute EMA. Returns the per-request results, log-likelihoods and
        pass counts plus the digest of `autobatch.summarize_service`.
        """
        cfg = self.cfg
        if policy is None:
            policy = FlushPolicy(kind=cfg.policy, max_batch=cfg.max_batch,
                                 max_wait=cfg.max_wait_s, slack=cfg.slack)
        estimator = ComputeEstimator(policy.ema_alpha,
                                     policy.default_compute)
        injector = None
        if chaos is not None and chaos.active:
            injector = ChaosInjector(chaos)
            requests, _ = injector.corrupt_requests(requests)
        qreqs = [QueuedRequest(req_id=i, n=len(ys), nx=self.model.nx,
                               arrival=float(t),
                               deadline=float(t) + cfg.deadline_s,
                               payload=ys, model_id=self.model_id,
                               method=self._icfg.method,
                               tenant=self.tenant)
                 for i, (ys, t) in enumerate(zip(requests, arrivals))]
        if cfg.warm:
            n_pads = {r.signature[2] for r in qreqs}
            b_pads = {policy.pad_width(k)
                      for k in range(1, cfg.max_batch + 1)}
            self.warmup(n_pads, b_pads,
                        estimator if policy.kind == "deadline" else None)
            if injector is not None:
                self.warmup_retry(n_pads)
        stats = _serve(qreqs, len(requests), self.run_flush, policy,
                       estimator, injector, self.retry_request, [self])
        emit(f"[serve/smoother/{policy.kind}] {stats['requests']} requests "
             f"in {stats['launches']} launches "
             f"(p50 {stats['latency_p50_s'] * 1e3:.1f}ms, "
             f"p95 {stats['latency_p95_s'] * 1e3:.1f}ms, "
             f"{stats['traj_per_s']:.1f} traj/s, "
             f"deadline hit {stats['deadline_hit_rate']:.0%}, "
             f"occupancy {stats['occupancy']:.2f})")
        _emit_chaos(stats, emit)
        return stats


def _serve(qreqs, n_requests, run_flush, policy, estimator, injector,
           retry, servers) -> dict:
    """Drive `run_service` over queued requests with ``run_flush(fl)``
    as the executor (wrapped by the chaos injector, if any, and an
    in-place retry of its transient errors); returns the stream stats.

    The queue's fault boundary absorbs only the injected
    `TransientComputeError`: any other executor exception (a kernel that
    fails to launch, a bug) propagates to the caller instead of coming
    back as retried requests."""
    results: List[Optional[torch.Tensor]] = [None] * n_requests
    logliks: List[Optional[float]] = [None] * n_requests
    iterations: List[Optional[int]] = [None] * n_requests
    iters_total = 0

    def execute(fl):
        nonlocal iters_total
        dt, outcomes, store, iters = run_flush(fl)
        for rid, (m, ll, p) in store.items():
            results[rid], logliks[rid], iterations[rid] = m, ll, p
        iters_total += iters
        return dt, outcomes

    exec_fn = execute
    if injector is not None:
        exec_fn = with_retries(injector.wrap_execute(execute),
                               max_retries=1,
                               retry_on=(TransientComputeError,))
    service = run_service(qreqs, exec_fn, policy, estimator, retry=retry,
                          watchdog=StepWatchdog(),
                          absorb=(TransientComputeError,))
    stats = summarize_service(service)
    stats.update({
        "results": results,
        "logliks": logliks,
        "iterations": iterations,
        "mean_iterations": iters_total / max(n_requests, 1),
        "compiles": sum(len(s.signatures_seen) for s in servers),
        "records": service["records"],
        "launch_log": service["launches"],
        "backend_choices": _backend_choices(),
        "chaos": injector.summary() if injector is not None else None,
    })
    return stats


def _emit_chaos(stats: dict, emit) -> None:
    if stats["chaos"] is not None:
        emit(f"[serve/chaos] injected {stats['chaos']['fault_kinds']}"
             f" + {stats['chaos']['exceptions']} transient exceptions"
             f" + {stats['chaos']['stragglers']} stragglers -> "
             f"verdicts {stats['verdicts']}")


# ---------------------------------------------------------------------------
# Multi-tenant serving (scenario registry tenants)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant of the multi-tenant smoother service: a registry
    scenario plus its SLO class. ``deadline_s=None`` takes the class
    default (`autobatch.SLO_CLASSES`); ``weight`` is the tenant's share
    of the generated request mix."""

    tenant: str
    scenario: str
    slo: str = "standard"
    weight: float = 1.0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {self.slo!r}; "
                             f"available: {sorted(SLO_CLASSES)}")

    @classmethod
    def parse(cls, spec: str) -> "TenantSpec":
        """CLI syntax: ``scenario[:slo[:weight]]`` (e.g.
        ``pendulum:gold`` or ``lorenz96:batch:0.5``); empty fields take
        the defaults."""
        parts = spec.split(":")
        name = parts[0]
        slo = parts[1] if len(parts) > 1 and parts[1] else "standard"
        try:
            weight = (float(parts[2])
                      if len(parts) > 2 and parts[2] else 1.0)
        except ValueError as e:
            raise ValueError(
                f"bad tenant spec {spec!r}: weight must be a float "
                f"(syntax: scenario[:slo[:weight]])") from e
        return cls(tenant=name, scenario=name, slo=slo, weight=weight)

    @property
    def slo_class(self):
        return SLO_CLASSES[self.slo]

    @property
    def budget_s(self) -> float:
        return (self.deadline_s if self.deadline_s is not None
                else self.slo_class.deadline_s)

    def smoother_spec(self, cfg: SmootherServeConfig) -> SmootherSpec:
        """The tenant's `SmootherSpec`: the registry scenario's production
        defaults (linearization, sigma scheme, damping, ``model_id``) plus
        the service-level iteration knobs."""
        from repro_torch.scenarios import get_scenario

        return get_scenario(self.scenario).default_spec(
            n_iter=cfg.n_iter, tol=cfg.tol,
            mode="parallel" if cfg.parallel else "sequential")


class MultiTenantServer:
    """One autobatching queue over several scenario models.

    Each tenant owns a `SmootherServer` built from its registry
    scenario's default smoother configuration; the queue's bucket
    signature ``(model_id, method, n_pad, nx)`` routes every flush back to
    the owning tenant, so batches never mix models. Deadlines and launch
    priority come from the tenant's SLO class; `summarize_service`
    reports the per-tenant latency and deadline-hit breakdown.
    """

    def __init__(self, tenants: List[TenantSpec], cfg: SmootherServeConfig,
                 device: Device = None):
        from repro_torch.scenarios import get_scenario

        if not tenants:
            raise ValueError("need at least one tenant")
        self.device = resolve_device(device)
        dtype = torch.float64 if cfg.f64 else torch.float32
        self.cfg = cfg
        self.specs: Dict[str, TenantSpec] = {}
        self.servers: Dict[str, SmootherServer] = {}
        self._by_model: Dict[Tuple[str, str], SmootherServer] = {}
        for tspec in tenants:
            if tspec.tenant in self.specs:
                raise ValueError(f"duplicate tenant {tspec.tenant!r}")
            sc = get_scenario(tspec.scenario)
            sspec = tspec.smoother_spec(cfg)
            server = SmootherServer(sc.make_model(dtype, self.device), cfg,
                                    spec=sspec, device=self.device,
                                    tenant=tspec.tenant)
            self.specs[tspec.tenant] = tspec
            self.servers[tspec.tenant] = server
            route = (server.model_id, sspec.method)
            if route in self._by_model:
                raise ValueError(
                    f"tenants {tspec.tenant!r} and "
                    f"{self._by_model[route].tenant!r} resolve to the same "
                    f"(model_id, method) route — deduplicate them upstream")
            self._by_model[route] = server
            # Retry-lane route: re-enqueued requests carry the retry
            # spec_id and must flush back to the owning server.
            self._by_model[(server.retry_model_id, sspec.method)] = server

    def scenario_of(self, tenant: str):
        return self.specs[tenant]

    def retry_request(self, req: QueuedRequest) -> QueuedRequest:
        """Route a failed request onto its owning server's retry lane."""
        return self._by_model[(req.model_id, req.method)] \
            .retry_request(req)

    def run_flush(self, fl):
        """Execute one flush on the server its signature routes to."""
        model_id, method, _, _ = fl.signature
        return self._by_model[(model_id, method)].run_flush(fl)

    def serve_stream(self, requests: List[Tuple[str, torch.Tensor]],
                     arrivals: np.ndarray, emit=print,
                     policy: Optional[FlushPolicy] = None,
                     chaos: Optional[ChaosConfig] = None) -> dict:
        """Serve a timestamped *mixed* stream of ``(tenant, ys)`` pairs.

        Per-tenant warmup warms each tenant's bucket shapes and seeds the
        shared compute estimator; ``chaos`` injects the seeded fault mix
        across the whole stream (see `SmootherServer.serve_stream`).
        """
        cfg = self.cfg
        if policy is None:
            policy = FlushPolicy(kind=cfg.policy, max_batch=cfg.max_batch,
                                 max_wait=cfg.max_wait_s, slack=cfg.slack)
        estimator = ComputeEstimator(policy.ema_alpha,
                                     policy.default_compute)
        injector = None
        if chaos is not None and chaos.active:
            injector = ChaosInjector(chaos)
            requests, _ = injector.corrupt_requests(requests)
        qreqs = []
        for i, ((tenant, ys), t) in enumerate(zip(requests, arrivals)):
            spec = self.specs[tenant]
            server = self.servers[tenant]
            qreqs.append(QueuedRequest(
                req_id=i, n=len(ys), nx=server.model.nx, arrival=float(t),
                deadline=float(t) + spec.budget_s, payload=ys,
                model_id=server.model_id, method=server.icfg.method,
                tenant=tenant, priority=spec.slo_class.priority))
        if cfg.warm:
            b_pads = {policy.pad_width(k)
                      for k in range(1, cfg.max_batch + 1)}
            for tenant, server in self.servers.items():
                n_pads = {r.signature[2] for r in qreqs
                          if r.tenant == tenant}
                if n_pads:
                    server.warmup(
                        n_pads, b_pads,
                        estimator if policy.kind == "deadline" else None)
                    if injector is not None:
                        server.warmup_retry(n_pads)
        stats = _serve(qreqs, len(requests), self.run_flush, policy,
                       estimator, injector, self.retry_request,
                       list(self.servers.values()))
        emit(f"[serve/smoother/mt/{policy.kind}] {stats['requests']} "
             f"requests, {len(self.servers)} tenants, "
             f"{stats['launches']} launches "
             f"(p95 {stats['latency_p95_s'] * 1e3:.1f}ms, "
             f"deadline hit {stats['deadline_hit_rate']:.0%}, "
             f"occupancy {stats['occupancy']:.2f})")
        _emit_chaos(stats, emit)
        for tenant, digest in stats.get("per_tenant", {}).items():
            emit(f"  [tenant {tenant} ({self.specs[tenant].slo})] "
                 f"{digest['requests']} reqs, "
                 f"p50 {digest['latency_p50_s'] * 1e3:.1f}ms, "
                 f"p95 {digest['latency_p95_s'] * 1e3:.1f}ms, "
                 f"deadline hit {digest['deadline_hit_rate']:.0%}")
        return stats


def _lengths(cfg_n: int, vary_lengths: bool) -> List[int]:
    """The request-length mix {n/2, 3n/4, n} (or n alone)."""
    return ([max(cfg_n // 2, 2), max((3 * cfg_n) // 4, 2), cfg_n]
            if vary_lengths else [cfg_n])


def make_tenant_fleet(server: MultiTenantServer, n_requests: int, n: int,
                      vary_lengths: bool = True, seed: int = 0):
    """A mixed-scenario request fleet for a multi-tenant server: per
    request, a tenant drawn by ``TenantSpec.weight`` and a length from
    the varied-length mix, from the JAX package's numpy stream (so both
    packages draw the same tenants and lengths), and a trajectory
    simulated on the server's device from a ``torch.Generator`` seeded
    with ``seed + i``. Returns ``(requests [(tenant, ys)], truths
    [xs])``."""
    from repro_torch.scenarios import get_scenario

    names = list(server.specs)
    weights = np.asarray([server.specs[t].weight for t in names])
    weights = weights / weights.sum()
    lengths = _lengths(n, vary_lengths)
    rng = np.random.default_rng(seed)
    requests, truths = [], []
    for i in range(n_requests):
        tenant = names[int(rng.choice(len(names), p=weights))]
        sc = get_scenario(server.specs[tenant].scenario)
        model = server.servers[tenant].model
        n_i = int(lengths[int(rng.integers(len(lengths)))])
        gen = torch.Generator(device=model.device).manual_seed(seed + i)
        xs, ys = sc.simulate(model, n_i, gen)
        requests.append((tenant, ys))
        truths.append(xs)
    return requests, truths


def _arrivals(cfg: SmootherServeConfig) -> np.ndarray:
    if cfg.arrival == "none":
        return np.zeros(cfg.requests)
    return make_arrivals(cfg.arrival, cfg.requests, cfg.rate,
                         cfg.burst_size, seed=cfg.seed)


def serve_smoother_multitenant(cfg: SmootherServeConfig,
                               tenants: List[TenantSpec], emit=print,
                               device: Device = None) -> dict:
    """Generate a mixed-scenario request fleet on ``device`` (default
    ``cuda``) and serve it through one multi-tenant queue. ``--arrival
    none`` degenerates to an all-at-t=0 stream. Stats gain the mean
    state RMSE and smoothed log-likelihood per tenant, over requests
    with verdict ok."""
    server = MultiTenantServer(tenants, cfg, device=device)
    requests, truths = make_tenant_fleet(server, cfg.requests, cfg.n,
                                         cfg.vary_lengths, cfg.seed)
    stats = server.serve_stream(requests, _arrivals(cfg), emit=emit,
                                chaos=cfg.chaos_config())
    ll_by: Dict[str, List[float]] = defaultdict(list)
    rmse_by: Dict[str, List[float]] = defaultdict(list)
    healthy = {r["req_id"] for r in stats["records"]
               if r["verdict"] == VERDICT_OK}
    for i, ((tenant, _), ll, mean, xs) in enumerate(
            zip(requests, stats["logliks"], stats["results"], truths)):
        if i not in healthy or mean is None:
            continue
        ll_by[tenant].append(ll)
        rmse_by[tenant].append(
            float(torch.sqrt(torch.mean((mean[1:] - xs[1:]) ** 2))))
    stats["mean_loglik_per_tenant"] = {
        t: float(np.mean(v)) for t, v in sorted(ll_by.items())}
    stats["mean_rmse_per_tenant"] = {
        t: float(np.mean(v)) for t, v in sorted(rmse_by.items())}
    for t in stats["mean_loglik_per_tenant"]:
        emit(f"  [tenant {t}] mean state RMSE "
             f"{stats['mean_rmse_per_tenant'][t]:.4f}, "
             f"mean smoothed loglik "
             f"{stats['mean_loglik_per_tenant'][t]:.1f}")
    return stats


def make_fleet(cfg: SmootherServeConfig, model: StateSpaceModel
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The synthetic request fleet of `serve_smoother`: ``cfg.requests``
    trajectories simulated on the model's device from a
    ``torch.Generator`` seeded with ``cfg.seed``, with lengths drawn from
    {n/2, 3n/4, n} (the JAX package's length draw). Returns the
    measurement sequences and the true states."""
    from repro_torch.scenarios.base import simulate_trajectory

    lengths = _lengths(cfg.n, cfg.vary_lengths)
    rng = np.random.default_rng(cfg.seed)
    ns = [int(lengths[int(rng.integers(len(lengths)))])
          for _ in range(cfg.requests)]
    gen = torch.Generator(device=model.device).manual_seed(cfg.seed)
    # One batched rollout at the longest length; the rollout is causal,
    # so each request's prefix is an n_i-step simulation of its own.
    xs, ys = simulate_trajectory(model, max(ns), gen, batch=(cfg.requests,))
    return ([ys[i, :n_i] for i, n_i in enumerate(ns)],
            [xs[i, :n_i + 1] for i, n_i in enumerate(ns)])


def serve_smoother(cfg: SmootherServeConfig, emit=print,
                   device: Device = None) -> dict:
    """Simulate a coordinated-turn request fleet on ``device`` (default
    ``cuda``) and serve it: one shot (``cfg.arrival == "none"``) or as a
    timestamped stream through the autobatching queue. Stats gain
    ``mean_rmse`` (position RMSE of the smoothed means against the
    simulated truth, over requests with verdict ok) and ``server`` (the
    warm server, for further streams)."""
    from repro_torch.scenarios import get_scenario

    device = resolve_device(device)
    dtype = torch.float64 if cfg.f64 else torch.float32
    sc = get_scenario("coordinated_turn")
    model = sc.make_model(dtype, device)
    requests, truths = make_fleet(cfg, model)
    sspec = sc.default_spec(
        linearization="taylor" if cfg.method == "ekf" else "slr",
        mode="parallel" if cfg.parallel else "sequential",
        n_iter=cfg.n_iter, tol=cfg.tol, lm_lambda=cfg.lm_lambda)
    server = SmootherServer(model, cfg, spec=sspec, device=device,
                            tenant=sc.name)
    if cfg.arrival == "none":
        stats = server.serve_requests(requests, emit=emit)
    else:
        stats = server.serve_stream(requests, _arrivals(cfg), emit=emit,
                                    chaos=cfg.chaos_config())
    # Only ok completions (or everything on the one-shot path) are scored:
    # corrupted requests track a corrupted measurement record.
    healthy = {r["req_id"] for r in stats.get("records", [])
               if r["verdict"] == VERDICT_OK}
    rmses = [float(torch.sqrt(torch.mean((m[1:, :2] - t[1:, :2]) ** 2)))
             for i, (m, t) in enumerate(zip(stats["results"], truths))
             if m is not None and ("records" not in stats or i in healthy)]
    stats["mean_rmse"] = float(np.mean(rmses)) if rmses else None
    stats["server"] = server
    if rmses:
        emit(f"[serve/smoother] mean position RMSE {stats['mean_rmse']:.4f}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="LM decode and batched iterated-smoother services "
                    "(PyTorch port)")
    p.add_argument("--workload", choices=("decode", "smoother"),
                   default="smoother",
                   help="the smoother service (default; the port's first "
                        "workload) or LM decoding")
    p.add_argument("--arch", default=None, help="decode: model architecture")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--method", choices=("ekf", "slr"), default="ekf",
                   help="linearization: ekf (Taylor, IEKS) or slr "
                        "(sigma-point, IPLS)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--sequential", action="store_true",
                   help="use the sequential baseline pass")
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--arrival", choices=("none", "poisson", "bursty"),
                   default="none",
                   help="request arrival process (none = one-shot batch)")
    p.add_argument("--policy", choices=("static", "deadline"),
                   default="static",
                   help="bucket flush policy for streaming mode")
    p.add_argument("--rate", type=float, default=8.0,
                   help="offered load, requests/s")
    p.add_argument("--burst-size", type=int, default=8)
    p.add_argument("--deadline", type=float, default=2.0,
                   help="per-request completion budget (s)")
    p.add_argument("--max-wait", type=float, default=0.25,
                   help="queue-wait cap (s)")
    p.add_argument("--tenants", type=str, default=None,
                   help="comma-separated scenario[:slo[:weight]] list (e.g. "
                        "coordinated_turn,pendulum:gold) — serves a mixed "
                        "multi-tenant stream")
    p.add_argument("--chaos", type=float, default=0.0, metavar="RATE",
                   help="inject the seeded fault mix at this headline rate "
                        "(NaN payloads + transient exceptions + stragglers;"
                        " streaming mode only)")
    p.add_argument("--chaos-seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)
    if args.workload == "decode":
        if args.arch is None:
            p.error("--arch is required for the decode workload")
        serve(ServeConfig(arch=args.arch, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          reduced=args.reduced),
              device=args.device)
        return
    cfg = SmootherServeConfig(
        requests=args.requests, n=args.n, max_batch=args.max_batch,
        method=args.method, n_iter=args.iters, tol=args.tol,
        parallel=not args.sequential, f64=not args.f32,
        arrival=args.arrival, policy=args.policy, rate=args.rate,
        burst_size=args.burst_size, deadline_s=args.deadline,
        max_wait_s=args.max_wait, chaos_rate=args.chaos,
        chaos_seed=args.chaos_seed)
    if args.chaos > 0 and args.arrival == "none":
        p.error("--chaos requires a streaming arrival process "
                "(--arrival poisson|bursty)")
    if args.tenants:
        serve_smoother_multitenant(
            cfg, [TenantSpec.parse(s) for s in args.tenants.split(",") if s],
            device=args.device)
    else:
        serve_smoother(cfg, device=args.device)


if __name__ == "__main__":
    main()
