"""Core smoothing stack of the port: types, combines and scans (and the
linear-recurrence scan), the sequential baseline, sigma-point schemes,
Taylor and SLR linearization, the GN cost, the batched iterated loop
(fixed or adaptive damping), the square-root form and the
`SmootherSpec`/`build_smoother` API."""
from .api import Smoother, SmootherSpec, build_smoother
from .cost import gn_cost, smoothing_cost
from .iterated import (LANE_CONVERGED, LANE_DIVERGED, LANE_MAX_ITERS,
                       IteratedConfig, LaneStatus,
                       initial_trajectory_batched, smoothed_log_likelihood)
from .linearization import (broadcast_noise_batched,
                            linearize_model_slr_batched,
                            linearize_model_taylor_batched, linearize_slr,
                            linearize_taylor)
from .scan import (LinearRecurrenceElement, linear_recurrence_combine,
                   linear_recurrence_scan)
from .sigma_points import cubature, gauss_hermite, get_scheme, unscented
from .sqrt_parallel import (SqrtFilteringElement, SqrtSmoothingElement,
                            sqrt_filtering_combine,
                            sqrt_parallel_filter_batched,
                            sqrt_parallel_smoother_batched,
                            sqrt_smoothing_combine, tria)
from .types import (FilteringElement, Gaussian, LinearizedSSM,
                    SmoothingElement, StateSpaceModel, resolve_device)

__all__ = [
    "Smoother", "SmootherSpec", "build_smoother", "IteratedConfig",
    "LaneStatus", "LANE_CONVERGED", "LANE_DIVERGED", "LANE_MAX_ITERS",
    "initial_trajectory_batched", "smoothed_log_likelihood",
    "gn_cost", "smoothing_cost",
    "cubature", "unscented", "gauss_hermite", "get_scheme",
    "linearize_taylor", "linearize_slr", "linearize_model_taylor_batched",
    "linearize_model_slr_batched", "broadcast_noise_batched",
    "SqrtFilteringElement", "SqrtSmoothingElement",
    "sqrt_filtering_combine", "sqrt_smoothing_combine",
    "sqrt_parallel_filter_batched", "sqrt_parallel_smoother_batched", "tria",
    "FilteringElement", "Gaussian", "LinearizedSSM", "SmoothingElement",
    "StateSpaceModel", "resolve_device", "linear_recurrence_scan",
    "linear_recurrence_combine", "LinearRecurrenceElement",
]
