"""Scenario registry of the port. Importing the package registers the
JAX package's full catalogue, with the same ``model_id`` strings:

  * ``coordinated_turn``       — paper §5 turn-rate tracking (nx=5, ekf)
  * ``bearings_only``          — CV target, passive bearings (nx=4, ekf)
  * ``pendulum``               — sin(theta) observation (nx=2, slr)
  * ``lorenz96``               — chaotic ring, partial obs (nx=8, ekf)
  * ``stochastic_volatility``  — AR(1) log-vol, exp obs (nx=1, slr)
  * ``population``             — logistic growth, exp obs (nx=1, slr)

``make_model(dtype, device)`` builds a model on a device;
``simulate(model, n, generator)`` samples from a ``torch.Generator`` on
that device.
"""
from .base import (Scenario, get_scenario, list_scenarios, register,
                   rollout, simulate_trajectory)
from . import (bearings_only, coordinated_turn, lorenz96, pendulum,
               population, stochastic_volatility)  # noqa: F401 (register)
from .coordinated_turn import (CoordinatedTurnConfig,
                               make_coordinated_turn_model)

__all__ = [
    "Scenario", "register", "get_scenario", "list_scenarios", "rollout",
    "simulate_trajectory", "CoordinatedTurnConfig",
    "make_coordinated_turn_model",
]
