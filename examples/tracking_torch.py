"""State-estimation end-to-end driver on the PyTorch port (the paper's
application): IEKS vs IPLS (cubature) on the coordinated-turn model,
with per-iteration RMSE, Levenberg-Marquardt damping, the square-root
form, and the CUDA combine kernels — every row is one `SmootherSpec`
through `build_smoother`.

    PYTHONPATH=src python examples/tracking_torch.py [--n 1000] [--iters 10]
        [--device cpu]

On the card the "CUDA combine" row (``combine_impl="pallas"``) runs the
hand-written kernels; on the CPU it runs their plain versions.
"""
import argparse
import time

import torch

from repro_torch.core import build_smoother
from repro_torch.scenarios import get_scenario


def rmse(est, truth):
    return float(torch.sqrt(torch.mean((est[1:, :2] - truth[1:, :2]) ** 2)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--scenario", default="coordinated_turn",
                   help="registry scenario name (position RMSE assumes a "
                        "tracking scenario)")
    p.add_argument("--device", default="cuda",
                   help="where the smoothers run (default: the card)")
    args = p.parse_args()

    scenario = get_scenario(args.scenario)
    model = scenario.make_model(dtype=torch.float32, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(7)
    xs, ys = scenario.simulate(model, args.n, gen)

    # Undamped IEKS/IPLS diverge on horizons beyond ~300 steps of this
    # model (Gauss-Newton property; paper ref [15]) — the damped rows show
    # the production-ready configuration (the scenario default). The
    # sqrt-form row is the float32-robust path.
    for label, spec in [
        ("IEKS  (Taylor, undamped)", scenario.default_spec(
            linearization="taylor", n_iter=args.iters, lm_lambda=0.0)),
        ("IPLS  (cubature SLR)    ", scenario.default_spec(
            linearization="slr", sigma_scheme="cubature",
            n_iter=args.iters, lm_lambda=0.0)),
        ("LM-IEKS (damped, 1.0)   ", scenario.default_spec(
            linearization="taylor", n_iter=args.iters, lm_lambda=1.0)),
        ("LM-IEKS (sqrt form)     ", scenario.default_spec(
            linearization="taylor", n_iter=args.iters, lm_lambda=1.0,
            form="sqrt")),
        ("LM-IEKS + CUDA combine  ", scenario.default_spec(
            linearization="taylor", n_iter=args.iters, lm_lambda=1.0,
            combine_impl="pallas")),
    ]:
        smoother = build_smoother(spec, device=args.device)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm, hist = smoother.iterate(model, ys, return_history=True)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        track = " -> ".join(f"{rmse(hist[i], xs):.4f}"
                            for i in range(0, args.iters,
                                           max(args.iters // 5, 1)))
        print(f"{label} {dt:6.2f}s  RMSE {track} => "
              f"{rmse(sm.mean, xs):.4f}")


if __name__ == "__main__":
    main()
