"""Backward-compatibility shim: the coordinated-turn model lives in the
scenario registry (`repro_torch.scenarios.coordinated_turn`), the generic
simulator in `repro_torch.scenarios.base`. Import from
`repro_torch.scenarios` in new code."""
from repro_torch.scenarios.base import simulate_trajectory
from repro_torch.scenarios.coordinated_turn import (
    CoordinatedTurnConfig, make_coordinated_turn_model)

__all__ = ["CoordinatedTurnConfig", "make_coordinated_turn_model",
           "simulate_trajectory"]
