"""Bearings-only tracking of a near-constant-velocity target.

The classic passive-sonar setup: a target moves with (noisy) constant
velocity, state ``x = [p_x, p_y, v_x, v_y]``, and is observed only
through bearings from two fixed sensors (two sensors make the problem
observable without ownship maneuvers). Linear dynamics + nonlinear
observation; the cheapest tenant in the catalogue (nx=4). Same constants
and ``params`` as the JAX package's scenario, so ``model_id`` agrees.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register
from .coordinated_turn import bearings_observation

# Sensors sit well off the flight corridor (range stays >~ 1): close
# sensors make the bearing residual so informative relative to R that
# even damped Gauss-Newton overshoots from the prior-tiled init.
DT = 0.02
Q_PSD = 0.05            # white-acceleration PSD
R_STD = 0.05            # bearing noise std (radians)
SENSOR1 = (-2.0, -1.0)
SENSOR2 = (2.0, 1.5)
M0 = (0.0, 0.5, 1.0, -0.2)
P0_DIAG = (0.1, 0.1, 0.1, 0.1)


def make_bearings_only_model(dtype=torch.float64, device=None
                             ) -> StateSpaceModel:
    dt = DT
    kw = dict(dtype=dtype, device=device)
    F = torch.tensor([[1, 0, dt, 0],
                      [0, 1, 0, dt],
                      [0, 0, 1, 0],
                      [0, 0, 0, 1]], **kw)

    def f(x):
        return (F @ x[..., None])[..., 0]

    # Discretized white-acceleration (constant-velocity) process noise.
    q = Q_PSD
    Q = torch.tensor([
        [q * dt ** 3 / 3, 0, q * dt ** 2 / 2, 0],
        [0, q * dt ** 3 / 3, 0, q * dt ** 2 / 2],
        [q * dt ** 2 / 2, 0, q * dt, 0],
        [0, q * dt ** 2 / 2, 0, q * dt],
    ], **kw)
    R = (R_STD ** 2) * torch.eye(2, **kw)
    return StateSpaceModel(f=f, h=bearings_observation(SENSOR1, SENSOR2,
                                                       dtype, device),
                           Q=Q, R=R, m0=torch.tensor(M0, **kw),
                           P0=torch.diag(torch.tensor(P0_DIAG, **kw)))


register(Scenario(
    name="bearings_only",
    build=make_bearings_only_model,
    nx=4, ny=2,
    default_method="ekf",
    lm_lambda=1.0,   # bearings residuals keep GN damping advisable
    description="Constant-velocity target, two-sensor bearings-only "
                "observations (passive tracking).",
    params=(("dt", DT), ("q_psd", Q_PSD), ("r_std", R_STD),
            ("sensor1", SENSOR1), ("sensor2", SENSOR2),
            ("m0", M0), ("p0_diag", P0_DIAG)),
))
