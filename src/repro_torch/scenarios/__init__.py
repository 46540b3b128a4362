"""Scenario registry of the port. Importing the package registers the
scenarios ported so far: ``coordinated_turn`` (paper §5, nx=5, ekf)."""
from .base import (Scenario, get_scenario, list_scenarios, register,
                   rollout, simulate_trajectory)
from . import coordinated_turn  # noqa: F401 (register)
from .coordinated_turn import (CoordinatedTurnConfig,
                               make_coordinated_turn_model)

__all__ = [
    "Scenario", "register", "get_scenario", "list_scenarios", "rollout",
    "simulate_trajectory", "CoordinatedTurnConfig",
    "make_coordinated_turn_model",
]
