"""Why the mesh-vs-reference train-step checks run at lr 3e-4: the port's
sharded step (four gloo ranks on the CPU, a 2 x 2 ("data", "model") mesh)
and the JAX package's own sharded step (8 host devices, Auto axes) take
the two steps of `tests/test_torch_mesh_train.py` on its inputs at a
given lr, and for each element past the suite's float32 TOL (``rtol=2e-4,
atol=2e-5``) in the parameters this prints both sides' parameter, each
step's (clipped) gradient, read from the AdamW moment ``m`` after each
step, and each step's update direction ``m_hat / (sqrt(v_hat) + eps)``,
beside the leaf's median gradient magnitude. An element whose gradient
is at float32 rounding has an update direction set by that rounding,
and moves by up to ``lr`` per step.

    PYTHONPATH=src python scripts/mesh_lr_probe.py [--lr 1e-2]
"""
import argparse
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "tests"))

B1, B2, EPS, STEPS = 0.9, 0.95, 1e-8, 2


def probe_rank(ctx, inp, lr):
    """Each arch's steps on the 2 x 2 mesh at ``lr``: rank 0's whole
    state after the last step, and its ``m`` after the first."""
    import torch

    import _train_mesh_cases as cases
    from repro_torch import convert
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as S
    from repro_torch.optim import AdamWConfig

    mesh = M.make_debug_mesh(*cases.SHAPE)
    out = {}
    for arch, (T, cf) in cases.STEP_ARCHS.items():
        cfg = cases.cfg_of(arch, capacity_factor=cf)
        model = convert.lm_params(inp["params"][arch], cfg, device="cpu")
        plan = S.make_train_step(cfg, mesh, ShapeConfig("t", T, cases.B,
                                                        "train"),
                                 opt_cfg=AdamWConfig(lr=lr),
                                 total_steps=cases.TOTAL, warmup_steps=0)
        state = plan.init_state(model)
        t = torch.as_tensor(inp["tokens"][arch], dtype=torch.int64)
        batch = S.batch_rows({"tokens": t, "labels": t}, mesh)
        m0 = None
        for _ in range(STEPS):
            state, _ = plan(state, batch)
            whole = cases._whole(plan, state)
            m0 = whole["m"] if m0 is None else m0
        out[arch] = dict(whole, m0=m0)
    return out if ctx.rank == 0 else None


def _steps_of(m0, m, v):
    """Each step's clipped gradient and update direction, from the first
    step's ``m`` and the second's ``m`` and ``v``."""
    g1 = m0 / (1 - B1)
    g2 = (m - B1 * m0) / (1 - B1)
    d2 = (m / (1 - B1 ** 2)) / (np.sqrt(v / (1 - B2 ** 2)) + EPS)
    return g1, g2, g1 / (np.abs(g1) + EPS), d2


#: The JAX step loop, saving ``m`` after the first step as well.
_GRAD_NORM = ('            out[f"{arch}/grad_norm/{s}"] = '
              'np.asarray(m["grad_norm"])\n')
_SAVE_M0 = _GRAD_NORM + """            if s == 0:
                for i, leaf in enumerate(leaves(state.opt.m)):
                    out[f"{arch}/m0/{i}"] = np.asarray(leaf)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=1e-2)
    lr = ap.parse_args().lr

    import _train_mesh_cases as cases
    import test_torch_mesh_train as t
    from repro_torch.launch.mesh import run_ranks

    cases.LR = lr
    tmp = tempfile.mkdtemp(prefix="mesh_lr_probe_")
    inputs = t._jax_inputs(tmp)
    assert _GRAD_NORM in t._STEPS
    steps = t._STEPS.replace(_GRAD_NORM, _SAVE_M0)
    oracle = t._jax_subprocess(t._HEAD + steps + t._TAIL, inputs,
                               os.path.join(tmp, "out.npz"), tuple(t.ARCHS))
    port = run_ranks(probe_rank, t.RANKS, dict(t._inputs(), params={
        a: t._jparams(a)[0] for a in t.ARCHS}), lr, device="cpu",
        emit=None)[0]
    tol = t.TOL
    print(f"lr {lr}: elements past TOL in the parameters after "
          f"{STEPS} steps (port on the mesh / JAX sharded)")
    for arch in t.ARCHS:
        want = {p: t._jax_part(oracle, arch, p) for p in ("params", "m",
                                                          "v", "m0")}
        got = port[arch]
        total = sum(w.size for w in want["params"].values())
        past, worst = 0, 0.0
        for n, w in want["params"].items():
            g = got["params"][n]
            ratio = np.abs(g - w) / (tol["atol"] + tol["rtol"] * np.abs(w))
            bad = np.argwhere(ratio > 1.0)
            past, worst = past + len(bad), max(worst, float(ratio.max()))
            _, leaf_g, _, _ = _steps_of(want["m0"][n], want["m"][n],
                                        want["v"][n])
            for idx in map(tuple, bad):
                pg, pw = (_steps_of(*(side[k][n][idx] for k in (
                    "m0", "m", "v"))) for side in (got, want))
                print(f"  {arch} {n}{[int(i) for i in idx]}: err/tol "
                      f"{ratio[idx]:.3g}; param {g[idx]:.9g} / "
                      f"{w[idx]:.9g}; step 1 g {pg[0]:.3g} / {pw[0]:.3g}, "
                      f"direction {pg[2]:.4g} / {pw[2]:.4g}; step 2 g "
                      f"{pg[1]:.3g} / {pw[1]:.3g} (the leaf's median |g| "
                      f"{np.median(np.abs(leaf_g)):.3g}), direction "
                      f"{pg[3]:.4g} / {pw[3]:.4g}")
        print(f"  {arch}: {past} of {total} parameter elements past TOL; "
              f"the largest err/tol {worst:.3g}")


if __name__ == "__main__":
    main()
