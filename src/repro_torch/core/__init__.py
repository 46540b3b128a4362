"""Core smoothing stack of the port: types, combines and scans (and the
linear-recurrence scan), the sequential baseline, Taylor linearization,
the GN cost, the batched iterated loop and the
`SmootherSpec`/`build_smoother` API."""
from .api import Smoother, SmootherSpec, build_smoother
from .iterated import (LANE_CONVERGED, LANE_DIVERGED, LANE_MAX_ITERS,
                       IteratedConfig, LaneStatus)
from .scan import (LinearRecurrenceElement, linear_recurrence_combine,
                   linear_recurrence_scan)
from .types import (FilteringElement, Gaussian, LinearizedSSM,
                    SmoothingElement, StateSpaceModel, resolve_device)

__all__ = [
    "Smoother", "SmootherSpec", "build_smoother", "IteratedConfig",
    "LaneStatus", "LANE_CONVERGED", "LANE_DIVERGED", "LANE_MAX_ITERS",
    "FilteringElement", "Gaussian", "LinearizedSSM", "SmoothingElement",
    "StateSpaceModel", "resolve_device", "linear_recurrence_scan",
    "linear_recurrence_combine", "LinearRecurrenceElement",
]
