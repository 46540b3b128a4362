"""Scenario smoke matrix: every registered scenario x both linearizations
x both forms, through `SmootherSpec` / `build_smoother`.

Each scenario must simulate, smooth with *both* linearization methods
(not just its default) at a tiny horizon, produce finite estimates, keep
parallel == sequential parity, and not degrade the fit score
(`Smoother.log_likelihood`) relative to the un-iterated prior trajectory.
The ``form="sqrt"`` cells also pin the square-root path against the
standard-form posterior. Same cells, gates and tolerances as the JAX
package's ``repro.scenarios.smoke``; runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.scenarios.smoke --device cpu \
        [--n 24] [--iters 3]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Callable, Optional

import torch

from repro_torch.core.api import build_smoother
from repro_torch.core.types import Device, Gaussian, resolve_device
from repro_torch.scenarios import get_scenario, list_scenarios

PARITY_TOL = 1e-6        # max-abs parallel-vs-sequential mean gap
SQRT_PARITY_TOL = 1e-6   # max-abs sqrt-vs-standard mean gap (float64)


def _prior_trajectory(model, n: int) -> Gaussian:
    return Gaussian(mean=model.m0.expand((n + 1,) + tuple(model.m0.shape)),
                    cov=model.P0.expand((n + 1,) + tuple(model.P0.shape)))


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def run_matrix(n: int = 24, n_iter: int = 3, methods=("ekf", "slr"),
               forms=("standard", "sqrt"), emit=print, device: Device = None,
               backend: str = "auto",
               measurements: Optional[Callable] = None) -> list:
    """Run the matrix on ``device`` (default ``cuda``); returns one result
    dict per (scenario, method, form) cell, with the smoothed means.

    ``measurements(name, model, n)`` gives each scenario's ``ys [n, ny]``;
    by default it is simulated from a ``torch.Generator`` seeded 0.
    ``backend`` is the specs' (``"jnp"`` runs the plain combines).
    """
    device = resolve_device(device)
    results = []
    for name in list_scenarios():
        sc = get_scenario(name)
        model = sc.make_model(torch.float64, device)
        if measurements is None:
            gen = torch.Generator(device=device).manual_seed(0)
            ys = sc.simulate(model, n, gen)[1]
        else:
            ys = measurements(name, model, n)
        for method in methods:
            spec = sc.default_spec(
                linearization="taylor" if method == "ekf" else "slr",
                n_iter=n_iter, backend=backend)
            smoother = build_smoother(spec, device=device)
            sm_par = smoother.iterate(model, ys)
            sm_seq = build_smoother(dataclasses.replace(
                spec, mode="sequential"), device=device).iterate(model, ys)
            gap = _max_abs(sm_par.mean, sm_seq.mean)
            ll = float(smoother.log_likelihood(model, ys, sm_par))
            ll0 = float(smoother.log_likelihood(
                model, ys, _prior_trajectory(model, n)))
            ok = (_finite(sm_par.mean) and gap < PARITY_TOL
                  and math.isfinite(ll) and ll >= ll0)
            results.append({
                "scenario": name, "method": method, "form": "standard",
                "model_id": sc.model_id, "spec_id": spec.spec_id,
                "nx": sc.nx, "ny": sc.ny, "par_seq_gap": gap,
                "loglik": ll, "loglik_prior": ll0, "ok": bool(ok),
                "mean": sm_par.mean,
            })
            emit(f"[smoke] {name:<24} {method:<4} standard nx={sc.nx} "
                 f"gap={gap:.2e} loglik={ll:9.2f} "
                 f"(prior {ll0:9.2f}) {'OK' if ok else 'FAIL'}")
            if "sqrt" not in forms:
                continue
            # Square-root form: same posterior as the standard parallel
            # path (float64), via the Cholesky-factor combines.
            spec_sq = dataclasses.replace(spec, form="sqrt")
            sm_sq = build_smoother(spec_sq, device=device).iterate(model, ys)
            sq_gap = _max_abs(sm_sq.mean, sm_par.mean)
            ll_sq = float(smoother.log_likelihood(model, ys, sm_sq))
            ok_sq = (_finite(sm_sq.mean) and sq_gap < SQRT_PARITY_TOL
                     and math.isfinite(ll_sq) and ll_sq >= ll0)
            results.append({
                "scenario": name, "method": method, "form": "sqrt",
                "model_id": sc.model_id, "spec_id": spec_sq.spec_id,
                "nx": sc.nx, "ny": sc.ny, "sqrt_std_gap": sq_gap,
                "loglik": ll_sq, "loglik_prior": ll0, "ok": bool(ok_sq),
                "mean": sm_sq.mean,
            })
            emit(f"[smoke] {name:<24} {method:<4} sqrt     nx={sc.nx} "
                 f"gap={sq_gap:.2e} loglik={ll_sq:9.2f} "
                 f"(prior {ll0:9.2f}) {'OK' if ok_sq else 'FAIL'}")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)
    results = run_matrix(n=args.n, n_iter=args.iters, device=args.device)
    failed = [r for r in results if not r["ok"]]
    print(f"[smoke] {len(results) - len(failed)}/{len(results)} "
          f"scenario x method x form cells green")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
