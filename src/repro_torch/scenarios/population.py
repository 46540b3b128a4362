"""Logistic population growth observed through noisy abundance counts.

The latent state is log-population ``u = log N``, with discretized
logistic drift ``u_{k+1} = u_k + r (1 - exp(u_k) / K) dt + q``, and the
observation is the abundance itself, ``y = exp(u) + noise``. Both maps are
nonlinear; the exponential observation spans two orders of magnitude over
a trajectory climbing toward the carrying capacity. Same constants and
``params`` as the JAX package's scenario, so ``model_id`` agrees.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register

GROWTH = 0.4       # intrinsic growth rate r
CAPACITY = 100.0   # carrying capacity K
DT = 0.1
Q_STD = 0.02       # log-population process noise std
R_STD = 2.0        # abundance observation noise std
M0 = 2.3           # log(10): start well below capacity
P0 = 0.05


def make_population_model(dtype=torch.float64, device=None
                          ) -> StateSpaceModel:
    kw = dict(dtype=dtype, device=device)

    def f(u):
        return u + GROWTH * (1.0 - torch.exp(u) / CAPACITY) * DT

    def h(u):
        return torch.exp(u)

    return StateSpaceModel(
        f=f, h=h,
        Q=(Q_STD ** 2) * torch.eye(1, **kw),
        R=(R_STD ** 2) * torch.eye(1, **kw),
        m0=torch.full((1,), M0, **kw),
        P0=P0 * torch.eye(1, **kw))


register(Scenario(
    name="population",
    build=make_population_model,
    nx=1, ny=1,
    default_method="slr",
    sigma_scheme="cubature",
    # The prior-tiled init sits orders of magnitude off in abundance
    # space on long horizons; strong damping keeps the early
    # Gauss-Newton steps from overshooting.
    lm_lambda=10.0,
    description="Logistic growth in log-population space, abundance "
                "(exp) observations.",
    params=(("growth", GROWTH), ("capacity", CAPACITY), ("dt", DT),
            ("q_std", Q_STD), ("r_std", R_STD), ("m0", M0), ("p0", P0)),
))
