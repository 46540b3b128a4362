"""Lorenz-96 chaotic dynamics with partial linear observations.

The standard data-assimilation benchmark:
``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F`` on a ring of ``d``
sites, integrated with one RK4 step per transition. Every other site is
observed directly — the smoother must reconstruct the unobserved half
through the coupling. The widest tenant in the catalogue (nx=8). Same
constants and ``params`` as the JAX package's scenario, so ``model_id``
agrees.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register

D = 8
FORCING = 8.0
DT = 0.02
Q_STD = 0.05     # per-step additive process noise
R_STD = 0.5      # observation noise on observed sites


def _l96_rhs(x):
    return ((torch.roll(x, -1, dims=-1) - torch.roll(x, 2, dims=-1))
            * torch.roll(x, 1, dims=-1) - x + FORCING)


def make_lorenz96_model(dtype=torch.float64, device=None) -> StateSpaceModel:
    dt = DT
    kw = dict(dtype=dtype, device=device)

    def f(x):
        k1 = _l96_rhs(x)
        k2 = _l96_rhs(x + 0.5 * dt * k1)
        k3 = _l96_rhs(x + 0.5 * dt * k2)
        k4 = _l96_rhs(x + dt * k3)
        return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def h(x):
        return x[..., ::2]

    Q = (Q_STD ** 2) * torch.eye(D, **kw)
    R = (R_STD ** 2) * torch.eye(D // 2, **kw)
    # Start near the attractor: the forcing fixed point plus a bump that
    # seeds the chaotic transient.
    m0 = torch.full((D,), FORCING, **kw)
    m0[0] += 1.0
    P0 = 0.5 * torch.eye(D, **kw)
    return StateSpaceModel(f=f, h=h, Q=Q, R=R, m0=m0, P0=P0)


register(Scenario(
    name="lorenz96",
    build=make_lorenz96_model,
    nx=D, ny=D // 2,
    default_method="ekf",
    lm_lambda=1.0,   # chaotic dynamics: keep Gauss-Newton damped
    description="Lorenz-96 ring (d=8, F=8, RK4), every other site "
                "observed.",
    params=(("d", D), ("forcing", FORCING), ("dt", DT),
            ("q_std", Q_STD), ("r_std", R_STD)),
))
