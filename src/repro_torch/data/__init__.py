"""Data substrates of the port: the state-estimation simulators (the LM
token pipeline, ``tokens``, waits for ROADMAP A, item 5f)."""
from .tracking import (CoordinatedTurnConfig, make_coordinated_turn_model,
                       simulate_trajectory)

__all__ = ["CoordinatedTurnConfig", "make_coordinated_turn_model",
           "simulate_trajectory"]
