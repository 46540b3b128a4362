"""Noisy pendulum with a sine observation (Särkkä, *Bayesian Filtering
and Smoothing*, example 5.1).

State ``x = [theta, dtheta]`` under Euler-discretized gravity dynamics;
the observation is ``sin(theta)``. Both maps are nonlinear, and the sine
observation folds symmetric states onto one measurement, which is where
sigma-point SLR beats a first-order Taylor expansion — the scenario
defaults to IPLS (cubature). Same constants and ``params`` as the JAX
package's scenario, so ``model_id`` agrees.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register

DT = 0.05
G = 9.81
Q_PSD = 0.2      # angular-acceleration noise PSD
R_STD = 0.1      # observation noise std
M0 = (1.2, 0.0)  # released off-vertical, at rest
P0_DIAG = (0.1, 0.5)


def make_pendulum_model(dtype=torch.float64, device=None) -> StateSpaceModel:
    dt = DT
    kw = dict(dtype=dtype, device=device)

    def f(x):
        theta, dtheta = x[..., 0], x[..., 1]
        return torch.stack([theta + dt * dtheta,
                            dtheta - dt * G * torch.sin(theta)], dim=-1)

    def h(x):
        return torch.sin(x[..., :1])

    # Discretized white angular-acceleration noise.
    Q = Q_PSD * torch.tensor([[dt ** 3 / 3, dt ** 2 / 2],
                              [dt ** 2 / 2, dt]], **kw)
    R = (R_STD ** 2) * torch.eye(1, **kw)
    return StateSpaceModel(f=f, h=h, Q=Q, R=R, m0=torch.tensor(M0, **kw),
                           P0=torch.diag(torch.tensor(P0_DIAG, **kw)))


register(Scenario(
    name="pendulum",
    build=make_pendulum_model,
    nx=2, ny=1,
    default_method="slr",
    sigma_scheme="cubature",
    description="Euler-discretized pendulum, sin(theta) observation "
                "(Särkkä example 5.1).",
    params=(("dt", DT), ("g", G), ("q_psd", Q_PSD), ("r_std", R_STD),
            ("m0", M0), ("p0_diag", P0_DIAG)),
))
