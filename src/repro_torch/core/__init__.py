"""Core smoothing stack of the port: the JAX package's public
`repro.core` surface, name for name, plus `resolve_device`.

  * THE estimator surface: `SmootherSpec` + `build_smoother(spec,
    device=...)` -> `Smoother` with ``filter``/``smooth``/``iterate``/
    ``log_likelihood``/``cost``, single or batched by ``ys.ndim``
  * types: Gaussian, LinearizedSSM, FilteringElement, SmoothingElement,
    StateSpaceModel
  * the drivers the spec dispatches onto: sequential baselines
    (kalman_filter, rts_smoother, filter_smoother), parallel-in-time
    (parallel_filter/_smoother/_filter_smoother, elements and combines),
    square-root forms, iterated drivers (iterated_smoother,
    IteratedConfig, LaneStatus and lane codes — IterationInfo is its
    legacy alias), smoothed_log_likelihood and the GN objective
    (smoothing_cost/gn_cost). Each single-trajectory driver is its
    batched twin on one lane.
  * scan engine: associative_scan (``batch_dims``-aware; the combine
    kernels on CUDA tensors under ``combine_impl="pallas"``),
    sharded_associative_scan and device_exclusive_scan (the cross-device
    scan over the ranks of a mesh axis, `repro_torch.distributed`: every
    ``axis_name`` above), linear_recurrence_scan
  * deprecated shims (warn once, delegate to build_smoother on
    ``ys.device``): ieks, ipls, and the ``*_filter_smoother_batched`` /
    ``iterated_smoother_batched`` twins

``python -m repro_torch.core.api --dump-surface`` prints the surface.
"""
from .types import (Gaussian, LinearizedSSM, FilteringElement,
                    SmoothingElement, StateSpaceModel, symmetrize,
                    mvn_logpdf, resolve_device)
from .sigma_points import cubature, unscented, gauss_hermite, get_scheme
from .linearization import (linearize_taylor, linearize_slr,
                            linearize_model_taylor, linearize_model_slr,
                            linearize_model_taylor_batched,
                            linearize_model_slr_batched,
                            broadcast_noise_batched)
from .sequential import (kalman_filter, rts_smoother, filter_smoother,
                         kalman_filter_batched, rts_smoother_batched,
                         filter_smoother_batched)
from .parallel import (filtering_elements, smoothing_elements,
                       filtering_elements_batched,
                       smoothing_elements_batched,
                       filtering_combine, smoothing_combine,
                       filtering_identity, smoothing_identity,
                       parallel_filter, parallel_smoother,
                       parallel_filter_smoother,
                       parallel_filter_batched, parallel_smoother_batched,
                       parallel_filter_smoother_batched)
from .cost import gn_cost, smoothing_cost
from .iterated import (IteratedConfig, IterationInfo, LaneStatus,
                       LANE_CONVERGED, LANE_DIVERGED, LANE_MAX_ITERS,
                       iterated_smoother,
                       iterated_smoother_batched, ieks, ipls,
                       initial_trajectory, initial_trajectory_batched,
                       smoothed_log_likelihood)
from .scan import (associative_scan, sharded_associative_scan,
                   device_exclusive_scan, linear_recurrence_scan,
                   linear_recurrence_combine, LinearRecurrenceElement)
from .sqrt_parallel import (SqrtFilteringElement, SqrtSmoothingElement,
                            sqrt_filtering_combine, sqrt_smoothing_combine,
                            sqrt_parallel_filter, sqrt_parallel_smoother,
                            sqrt_parallel_filter_smoother,
                            sqrt_parallel_filter_batched,
                            sqrt_parallel_smoother_batched,
                            sqrt_parallel_filter_smoother_batched, tria)
from .api import SmootherSpec, Smoother, build_smoother

__all__ = [
    "SmootherSpec", "Smoother", "build_smoother",
    "Gaussian", "LinearizedSSM", "FilteringElement", "SmoothingElement",
    "StateSpaceModel", "symmetrize", "mvn_logpdf", "resolve_device",
    "cubature", "unscented", "gauss_hermite", "get_scheme",
    "linearize_taylor", "linearize_slr", "linearize_model_taylor",
    "linearize_model_slr", "linearize_model_taylor_batched",
    "linearize_model_slr_batched", "broadcast_noise_batched",
    "kalman_filter", "rts_smoother", "filter_smoother",
    "kalman_filter_batched", "rts_smoother_batched",
    "filter_smoother_batched",
    "filtering_elements", "smoothing_elements",
    "filtering_elements_batched", "smoothing_elements_batched",
    "filtering_combine", "smoothing_combine", "filtering_identity",
    "smoothing_identity",
    "parallel_filter", "parallel_smoother", "parallel_filter_smoother",
    "parallel_filter_batched", "parallel_smoother_batched",
    "parallel_filter_smoother_batched",
    "IteratedConfig", "IterationInfo", "LaneStatus",
    "LANE_CONVERGED", "LANE_DIVERGED", "LANE_MAX_ITERS",
    "gn_cost", "smoothing_cost", "iterated_smoother",
    "iterated_smoother_batched", "ieks", "ipls",
    "initial_trajectory", "initial_trajectory_batched",
    "smoothed_log_likelihood",
    "associative_scan", "sharded_associative_scan", "device_exclusive_scan",
    "linear_recurrence_scan",
    "linear_recurrence_combine", "LinearRecurrenceElement",
    "SqrtFilteringElement", "SqrtSmoothingElement",
    "sqrt_filtering_combine", "sqrt_smoothing_combine",
    "sqrt_parallel_filter", "sqrt_parallel_smoother",
    "sqrt_parallel_filter_smoother", "sqrt_parallel_filter_batched",
    "sqrt_parallel_smoother_batched",
    "sqrt_parallel_filter_smoother_batched", "tria",
]
