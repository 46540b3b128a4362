"""Quickstart on the PyTorch port: parallel IEKS on the paper's
coordinated-turn model.

Simulates a bearings-only tracking problem, runs the paper's
parallel-in-time iterated extended Kalman smoother (M=10) through the
unified `SmootherSpec`/`build_smoother` API, and compares against the
sequential baseline — same posterior, logarithmic span. On the card the
parallel scans run the CUDA combine kernels (each level a ``[1, P]``
grid of element pairs); ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.core import build_smoother
from repro_torch.scenarios import get_scenario


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="where the smoother runs (default: the card)")
    args = p.parse_args()

    # The registry scenario carries the model factory, simulator, and
    # production smoother defaults (linearization, damping, model_id) —
    # `default_spec` packages them as one declarative SmootherSpec.
    scenario = get_scenario("coordinated_turn")
    model = scenario.make_model(dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    xs, ys = scenario.simulate(model, 400, gen)
    print(f"simulated {ys.shape[0]} bearings-only measurements")

    # Levenberg-Marquardt damping (paper ref [15], the scenario default)
    # keeps Gauss-Newton convergent on long horizons; undamped IEKS
    # diverges for n >~ 300 on this model (in parallel AND sequential
    # form — an optimization property, not a parallelization artifact).
    spec = scenario.default_spec(n_iter=10)       # mode="parallel" default
    smoother = build_smoother(spec, device=args.device)
    sm_par = smoother.iterate(model, ys)
    sm_seq = build_smoother(dataclasses.replace(spec, mode="sequential"),
                            device=args.device).iterate(model, ys)

    rmse = torch.sqrt(torch.mean((sm_par.mean[1:, :2] - xs[1:, :2]) ** 2))
    gap = torch.max(torch.abs(sm_par.mean - sm_seq.mean))
    print(f"spec: {spec.mode}/{spec.form}/{spec.linearization} "
          f"(spec_id {spec.spec_id}) on {smoother.device}")
    print(f"IEKS (parallel scan, M=10): position RMSE = {float(rmse):.4f}")
    print(f"parallel vs sequential max-abs gap = {float(gap):.2e}")
    print("span: sequential O(n) = 400 combines/pass; "
          "parallel O(log n) = ~18 levels/pass")


if __name__ == "__main__":
    main()
