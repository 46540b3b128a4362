"""Smoother service: batched state estimation of many trajectories at once.

A fleet of smoothing requests with heterogeneous trajectory lengths is
bucketed by ``(spec_id, method, next_pow2(n), nx)``, padded along time
with uninformative measurements (R inflated by ``R_PAD_SCALE``, so padded
steps carry no information) and along batch by replicating lane 0 up to a
power-of-two width, then each bucket runs as ONE batched iterated
smoother call — B trajectories per combine launch of every scan level.

    python -m repro_torch.launch.serve --workload smoother --arrival none \
        --requests 64 --n 512 --max-batch 64 --tol 1e-6 [--method slr]

runs on the card (``--device cpu`` runs the plain PyTorch path on the
CPU). This is the one-shot path (``--arrival none``); the streaming queue,
the retry lane, the sequential fallback, chaos and multi-tenancy are later
slices of the port.
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
from repro_torch.launch.autobatch import pad_width, spec_signature

R_PAD_SCALE = 1e8  # measurement-noise inflation on padded time steps


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

    Requests (``ys [n_i, ny]``) are grouped by `autobatch.spec_signature`;
    inside a bucket the time axis is padded to the bucket length and the
    batch axis to a power-of-two launch width (`pad_requests`). The
    smoother is ``build_smoother(spec, device=device)``; with no ``spec``
    it is built from the `SmootherServeConfig` knobs.
    """

    def __init__(self, model: StateSpaceModel, cfg: SmootherServeConfig,
                 spec: Optional[SmootherSpec] = None, device: Device = None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, server runs "
                             f"on {self.device}")
        self.model = model
        self.cfg = cfg
        if spec is None:
            spec = SmootherSpec(
                mode="parallel" if cfg.parallel else "sequential",
                linearization=("taylor" if cfg.method == "ekf"
                               else "slr"),
                n_iter=cfg.n_iter, tol=cfg.tol, lm_lambda=cfg.lm_lambda)
        self.spec = spec
        self._smoother = build_smoother(spec, device=self.device)

    def queue_signature(self, n: int):
        """The bucket key for a request of length ``n``."""
        return spec_signature(self.spec, n, self.model.nx)

    def _run(self, ys: torch.Tensor, r_stack: torch.Tensor):
        model_b = dataclasses.replace(self.model, R=r_stack)
        traj, info = self._smoother.iterate(model_b, ys, return_info=True)
        # Per-step fit scores; padded steps are masked below (their
        # inflated-R terms belong to no request).
        ll_steps = self._smoother.log_likelihood(model_b, ys, traj,
                                                 per_step=True)
        return traj, info, ll_steps

    def smooth_batch(self, batch: List[torch.Tensor], n_pad: int,
                     b_pad: int):
        """Run one padded bucket launch. Returns per-request smoothed
        means (``[n_i + 1, nx]`` tensors), the per-lane `LaneStatus`,
        per-request log-likelihood fit scores over real steps only, and
        per-request health (finite posterior, not `LANE_DIVERGED`)."""
        ys, rs = pad_requests(batch, n_pad, b_pad, self.model.R)
        traj, info, ll_steps = self._run(ys, rs)
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

    def warmup(self, n_pads, b_pads) -> None:
        """Run one dummy launch per ``(n_pad, b_pad)`` bucket shape, so the
        kernels are built and the card's libraries initialized before the
        first timed request."""
        for n_pad in sorted(set(n_pads)):
            dummy = [torch.zeros((n_pad, self.model.ny),
                                 dtype=self.model.R.dtype,
                                 device=self.device)]
            for b_pad in sorted(set(b_pads)):
                self.smooth_batch(dummy, n_pad, b_pad)

    def serve_requests(self, requests: List[torch.Tensor], emit=print
                       ) -> dict:
        """Bucket, pad, and smooth a full request list; returns stats."""
        buckets: Dict[tuple, List[int]] = defaultdict(list)
        for idx, ys in enumerate(requests):
            buckets[self.queue_signature(len(ys))].append(idx)

        results: List[Optional[torch.Tensor]] = [None] * len(requests)
        logliks: List[Optional[float]] = [None] * len(requests)
        codes: List[Optional[int]] = [None] * len(requests)
        launches = 0
        iters_total = 0
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
                for i, m, ll, code in zip(chunk, means, lls, lane_codes):
                    results[i] = m
                    logliks[i] = ll
                    codes[i] = code
                launches += 1
                iters_total += int(info.iterations[:len(chunk)].sum())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        stats = {
            "results": results,
            "logliks": logliks,
            "codes": codes,
            "requests": len(requests),
            "launches": launches,
            "mean_iterations": iters_total / max(len(requests), 1),
            "wall_s": dt,
            "traj_per_s": len(requests) / dt,
        }
        emit(f"[serve/smoother] {len(requests)} requests in {launches} "
             f"bucket launches, {dt:.2f}s ({stats['traj_per_s']:.1f} traj/s,"
             f" {stats['mean_iterations']:.1f} mean iters)")
        return stats


def make_fleet(cfg: SmootherServeConfig, model: StateSpaceModel
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The synthetic request fleet of `serve_smoother`: ``cfg.requests``
    trajectories simulated on the model's device from a
    ``torch.Generator`` seeded with ``cfg.seed``, with lengths drawn from
    {n/2, 3n/4, n} (the JAX package's length draw). Returns the
    measurement sequences and the true states."""
    from repro_torch.scenarios.base import simulate_trajectory

    lengths = ([max(cfg.n // 2, 2), max((3 * cfg.n) // 4, 2), cfg.n]
               if cfg.vary_lengths else [cfg.n])
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
    ``cuda``) and serve it; stats gain ``mean_rmse`` (position RMSE of
    the smoothed means against the simulated truth)."""
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
    server = SmootherServer(model, cfg, spec=sspec, device=device)
    stats = server.serve_requests(requests, emit=emit)
    rmses = [float(torch.sqrt(torch.mean((m[1:, :2] - t[1:, :2]) ** 2)))
             for m, t in zip(stats["results"], truths)]
    stats["mean_rmse"] = float(np.mean(rmses)) if rmses else None
    if rmses:
        emit(f"[serve/smoother] mean position RMSE {stats['mean_rmse']:.4f}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Batched iterated-smoother service (PyTorch port)")
    p.add_argument("--workload", choices=("smoother",), default="smoother")
    p.add_argument("--arrival", choices=("none",), default="none",
                   help="request arrival process (none = one-shot batch)")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--method", choices=("ekf", "slr"), default="ekf",
                   help="linearization: ekf (Taylor, IEKS) or slr "
                        "(sigma-point, IPLS)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--lm-lambda", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sequential", action="store_true",
                   help="use the sequential baseline pass")
    p.add_argument("--f32", action="store_true", help="run in float32")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)
    cfg = SmootherServeConfig(
        requests=args.requests, n=args.n, max_batch=args.max_batch,
        method=args.method, n_iter=args.iters, tol=args.tol,
        lm_lambda=args.lm_lambda, seed=args.seed,
        parallel=not args.sequential, f64=not args.f32)
    serve_smoother(cfg, device=args.device)


if __name__ == "__main__":
    main()
