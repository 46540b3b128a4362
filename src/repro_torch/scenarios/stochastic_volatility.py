"""Stochastic volatility: AR(1) log-volatility, exponential observation.

Latent log-volatility follows a stationary AR(1), ``x_{k+1} = phi x_k +
q``, and the observed magnitude is ``beta exp(x/2) + r`` (the
additive-Gaussian variant that fits the model contract, paper Eq. 4). The
exponential observation is strongly convex, which makes sigma-point SLR
with the unscented scheme the robust default. Same constants and
``params`` as the JAX package's scenario, so ``model_id`` agrees.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register

PHI = 0.97       # AR(1) persistence
Q_STD = 0.15     # log-vol innovation std
BETA = 0.7       # volatility scale
R_STD = 0.1      # additive observation noise std
P0 = 0.4         # prior variance (near stationary Q_STD^2/(1-PHI^2))


def make_stochastic_volatility_model(dtype=torch.float64, device=None
                                     ) -> StateSpaceModel:
    kw = dict(dtype=dtype, device=device)

    def f(x):
        return PHI * x

    def h(x):
        return BETA * torch.exp(0.5 * x)

    return StateSpaceModel(
        f=f, h=h,
        Q=(Q_STD ** 2) * torch.eye(1, **kw),
        R=(R_STD ** 2) * torch.eye(1, **kw),
        m0=torch.zeros((1,), **kw),
        P0=P0 * torch.eye(1, **kw))


register(Scenario(
    name="stochastic_volatility",
    build=make_stochastic_volatility_model,
    nx=1, ny=1,
    default_method="slr",
    sigma_scheme="unscented",
    description="AR(1) log-volatility, y = beta*exp(x/2) + r "
                "(additive-Gaussian SV variant).",
    params=(("phi", PHI), ("q_std", Q_STD), ("beta", BETA),
            ("r_std", R_STD), ("p0", P0)),
))
