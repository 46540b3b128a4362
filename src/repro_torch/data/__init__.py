"""Data substrates of the port: the state-estimation simulators and the
LM token pipeline (``data.tokens``, numpy only; like the reference's
package, this one re-exports the simulators' names alone)."""
from .tracking import (CoordinatedTurnConfig, make_coordinated_turn_model,
                       simulate_trajectory)

__all__ = ["CoordinatedTurnConfig", "make_coordinated_turn_model",
           "simulate_trajectory"]
