"""Batched iterated smoother (IEKS, fixed Levenberg-Marquardt damping).

The outer loop (paper §3) repeats up to M times: linearize the model
around the previous smoothed trajectory, then run one filter + smoother
pass — parallel-in-time (the paper's method) or sequential (baseline).
Optional LM damping (Särkkä & Svensson 2020) augments each measurement
with a pseudo-observation of the previous iterate with covariance
``(1/lambda) I``.

With ``tol > 0`` a per-lane active mask freezes converged trajectories and
the loop stops once every lane is done: the JAX package's ``while_loop``
becomes a Python loop that synchronizes once per pass on
``active.any()``. ``tol = 0`` runs exactly ``n_iter`` passes. Adaptive
damping, SLR and the square-root form are later slices of the port and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from . import parallel, sequential
from .cost import gn_cost
from .linearization import linearize_model_taylor_batched
from .types import (Gaussian, LinearizedSSM, StateSpaceModel, bmm, bmv,
                    mvn_logpdf)

#: Axis vocabularies shared with `repro_torch.core.api.SmootherSpec` (the
#: JAX package's, value for value, so validation and ``spec_id`` agree).
FORMS = ("standard", "sqrt")
COMBINE_IMPLS = ("auto", "jnp", "fused", "pallas")
DAMPINGS = ("fixed", "adaptive")
BACKENDS = ("auto", "jnp", "tpu", "gpu")
SIGMA_SCHEMES = ("cubature", "unscented", "gauss_hermite")

#: `LaneStatus.code` vocabulary: the per-lane verdict of the outer loop.
LANE_CONVERGED = 0   # mean delta fell below tol (requires tol > 0)
LANE_MAX_ITERS = 1   # iteration budget exhausted while still finite
LANE_DIVERGED = 2    # non-finite iterate


def validate_iteration_knobs(n_iter: int, tol: float, lm_lambda: float,
                             jitter: float) -> None:
    """Shared numeric-knob validation for IteratedConfig/SmootherSpec."""
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    if tol < 0.0:
        raise ValueError(f"tol must be >= 0, got {tol}")
    if lm_lambda < 0.0:
        raise ValueError(f"lm_lambda must be >= 0, got {lm_lambda}")
    if jitter < 0.0:
        raise ValueError(f"jitter must be >= 0, got {jitter}")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP queue A item {item})")


@dataclasses.dataclass(frozen=True)
class IteratedConfig:
    method: str = "ekf"             # "ekf" (IEKS) | "slr" (IPLS)
    n_iter: int = 10                # paper uses M = 10 (max iters if tol>0)
    parallel: bool = True           # paper's contribution vs. baseline
    sigma_scheme: str = "cubature"  # for method="slr"
    lm_lambda: float = 0.0          # Levenberg-Marquardt damping (0 = off)
    combine_impl: str = "auto"      # "auto" | "jnp" | "fused" | "pallas"
    jitter: float = 0.0
    tol: float = 0.0                # early-stop mean-delta tol (0 = fixed M)
    model_id: str = ""              # scenario content hash / spec_id
    form: str = "standard"          # "standard" | "sqrt" (parallel only)
    damping: str = "fixed"          # "fixed" | "adaptive" (per-lane LM)
    backend: str = "auto"           # "auto" | "jnp" | "tpu" | "gpu"

    def __post_init__(self):
        if self.method not in ("ekf", "slr"):
            raise ValueError(f"unknown method {self.method!r}; "
                             f"available: ['ekf', 'slr']")
        if self.form not in FORMS:
            raise ValueError(f"unknown form {self.form!r}; "
                             f"available: {sorted(FORMS)}")
        if self.form == "sqrt" and not self.parallel:
            raise ValueError(
                'form="sqrt" requires parallel=True: no sequential '
                "square-root pass is implemented")
        if self.sigma_scheme not in SIGMA_SCHEMES:
            raise ValueError(
                f"unknown sigma-point scheme {self.sigma_scheme!r}; "
                f"available: {sorted(SIGMA_SCHEMES)}")
        if self.combine_impl not in COMBINE_IMPLS:
            raise ValueError(
                f"unknown combine_impl {self.combine_impl!r}; "
                f"available: {sorted(COMBINE_IMPLS)}")
        if self.damping not in DAMPINGS:
            raise ValueError(f"unknown damping {self.damping!r}; "
                             f"available: {sorted(DAMPINGS)}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"available: {sorted(BACKENDS)}")
        if self.combine_impl == "pallas" and self.backend == "jnp":
            raise ValueError(
                'combine_impl="pallas" contradicts backend="jnp" '
                "(a compiled kernel with kernels disabled) — drop one")
        validate_iteration_knobs(self.n_iter, self.tol, self.lm_lambda,
                                 self.jitter)

    def check_ported(self) -> None:
        """Raise for the axis values later slices of the port add."""
        if self.method == "slr":
            raise not_ported('linearization="slr"', "6")
        if self.form == "sqrt":
            raise not_ported('form="sqrt"', "9")
        if self.damping == "adaptive":
            raise not_ported('damping="adaptive"', "7")
        if self.backend == "tpu":
            raise ValueError('backend="tpu" has no lowering in the PyTorch '
                             'port; use "auto", "gpu" or "jnp"')

    def resolved_combine_impl(self) -> str:
        """The scan's ``combine_impl`` for a batched call site.

        An explicit ``combine_impl`` wins; ``"auto"`` takes the CUDA
        kernels (``"pallas"``) unless ``backend="jnp"`` asks for the
        plain versions (``"fused"``). The kernel wrappers themselves run
        the plain version on CPU tensors. There is no autotuner yet, so
        ``backend="auto"`` means "kernel on the card".
        """
        if self.combine_impl == "auto":
            return "fused" if self.backend == "jnp" else "pallas"
        return self.combine_impl


class LaneStatus(NamedTuple):
    """Per-lane verdict of the outer loop (``[B]`` fields).

    ``code`` is one of `LANE_CONVERGED` / `LANE_MAX_ITERS` /
    `LANE_DIVERGED`; ``iterations`` counts the passes the lane executed;
    ``final_delta`` is the last mean update; ``final_cost`` the GN cost of
    the returned trajectory (zeros unless ``return_info`` asked for it).
    """

    iterations: torch.Tensor
    final_delta: torch.Tensor
    code: torch.Tensor
    final_cost: torch.Tensor


def _augment_lm(lin: LinearizedSSM, prev_means: torch.Tensor, lam: float
                ) -> Tuple[LinearizedSSM, torch.Tensor]:
    """LM damping: pseudo-measurement ``x_k ~ N(prev_mean_k, (1/lam) I)``.

    Returns the augmented model and the pseudo measurements (the caller
    concatenates the real ys with them along the last axis).
    """
    ny, nx = lin.H.shape[-2:]
    lead = tuple(lin.H.shape[:-2])
    kw = dict(dtype=lin.H.dtype, device=lin.H.device)
    I = torch.eye(nx, **kw).expand(lead + (nx, nx))
    H_aug = torch.cat([lin.H, I], dim=-2)
    d_aug = torch.cat([lin.d, torch.zeros(lead + (nx,), **kw)], dim=-1)
    R_pad = torch.zeros(lead + (ny, nx), **kw)
    R_top = torch.cat([lin.Rp, R_pad], dim=-1)
    R_bot = torch.cat([R_pad.transpose(-1, -2), I * (1.0 / lam)], dim=-1)
    Rp_aug = torch.cat([R_top, R_bot], dim=-2)
    return LinearizedSSM(F=lin.F, c=lin.c, Qp=lin.Qp,
                         H=H_aug, d=d_aug, Rp=Rp_aug), prev_means


def _one_pass_batched(model: StateSpaceModel, ys: torch.Tensor,
                      traj: Gaussian, cfg: IteratedConfig) -> Gaussian:
    """One linearize->filter->smooth pass over ``[B, n]`` trajectories."""
    lin = linearize_model_taylor_batched(model, traj.mean)
    ys_eff = ys
    if cfg.lm_lambda > 0.0:
        lin, pseudo = _augment_lm(lin, traj.mean[:, 1:], cfg.lm_lambda)
        ys_eff = torch.cat([ys, pseudo], dim=-1)
    if cfg.parallel:
        _, smoothed = parallel._parallel_filter_smoother_batched(
            lin, ys_eff, model.m0, model.P0,
            combine_impl=cfg.resolved_combine_impl())
    else:
        _, smoothed = sequential._filter_smoother_batched(
            lin, ys_eff, model.m0, model.P0)
    return smoothed


def initial_trajectory_batched(model: StateSpaceModel, B: int, n: int
                               ) -> Gaussian:
    """Nominal initialization: the prior tiled along every trajectory."""
    mean = model.m0.expand((B, n + 1) + tuple(model.m0.shape))
    cov = model.P0.expand((B, n + 1) + tuple(model.P0.shape))
    return Gaussian(mean=mean, cov=cov)


def _mean_delta(new: Gaussian, old: Gaussian) -> torch.Tensor:
    return torch.amax(torch.abs(new.mean - old.mean), dim=(1, 2))


def _finite_lanes(traj: Gaussian) -> torch.Tensor:
    """Per-lane all-finite check over means and covariances (``[B]``)."""
    return (torch.isfinite(traj.mean).all(dim=(1, 2))
            & torch.isfinite(traj.cov).all(dim=(1, 2, 3)))


def _make_info(model, ys, traj, cfg, iterations, delta, converged,
               want_cost: bool) -> LaneStatus:
    """Final `LaneStatus`: classify each lane from its finiteness and
    convergence flag; evaluate the GN cost only when asked."""
    finite = _finite_lanes(traj)
    if want_cost:
        cost = gn_cost(model, ys, traj, cfg.method)
    else:
        cost = torch.zeros(finite.shape, dtype=traj.mean.dtype,
                           device=traj.mean.device)
    code = torch.where(
        finite,
        torch.where(converged, LANE_CONVERGED, LANE_MAX_ITERS),
        LANE_DIVERGED).to(torch.int32)
    return LaneStatus(iterations=iterations, final_delta=delta,
                      code=code, final_cost=cost)


def _freeze_lanes(active: torch.Tensor, new: Gaussian, old: Gaussian
                  ) -> Gaussian:
    """Keep the old trajectory on lanes whose mask is False."""
    def sel(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (n.ndim - 1)),
                           n, o)
    return Gaussian(*(sel(n, o) for n, o in zip(new, old)))


def _iterated_smoother_batched(model: StateSpaceModel, ys: torch.Tensor,
                               cfg: IteratedConfig = IteratedConfig(),
                               init: Optional[Gaussian] = None,
                               return_info: bool = False):
    """Batched iterated smoother over ``ys [B, n, ny]``.

    Every pass runs all B trajectories through one batched
    filter+smoother; with ``cfg.tol > 0`` converged lanes freeze
    (``info.iterations`` records per-lane pass counts) and the loop exits
    once every lane has converged. Returns ``[B, n+1, ...]`` marginals
    (and a `LaneStatus` with ``return_info``).
    """
    cfg.check_ported()
    B, n = ys.shape[:2]
    traj = init if init is not None else initial_trajectory_batched(
        model, B, n)
    M = cfg.n_iter
    dev = ys.device

    if cfg.tol <= 0.0:
        for _ in range(M):
            new = _one_pass_batched(model, ys, traj, cfg)
            delta = _mean_delta(new, traj)
            traj = new
        info = _make_info(model, ys, traj, cfg,
                          iterations=torch.full((B,), M, dtype=torch.int32,
                                                device=dev),
                          delta=delta,
                          converged=torch.zeros((B,), dtype=torch.bool,
                                                device=dev),
                          want_cost=return_info)
        return (traj, info) if return_info else traj

    active = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    delta = torch.full((B,), float("inf"), dtype=traj.mean.dtype, device=dev)
    it = 0
    while it < M and bool(active.any()):
        new = _one_pass_batched(model, ys, traj, cfg)
        new = _freeze_lanes(active, new, traj)
        step_delta = _mean_delta(new, traj)
        delta = torch.where(active, step_delta, delta)
        iters = iters + active.to(torch.int32)
        active = active & (step_delta > cfg.tol)
        traj = new
        it += 1
    info = _make_info(model, ys, traj, cfg, iterations=iters, delta=delta,
                      converged=delta <= cfg.tol, want_cost=return_info)
    return (traj, info) if return_info else traj


def smoothed_log_likelihood(model: StateSpaceModel, ys: torch.Tensor,
                            traj: Gaussian,
                            cfg: IteratedConfig = IteratedConfig(),
                            per_step: bool = False) -> torch.Tensor:
    """Measurement log-likelihood under the smoothed posterior.

    Each step's observation is scored against its posterior predictive
    under the Taylor linearization at ``traj``:
    ``y_k ~ N(H_k m_k + d_k, H_k P_k H_k^T + Rp_k)``, summed over time
    (``per_step=True`` returns the per-step terms — serving masks padded
    steps before summing). ``ys [B, n, ny]`` gives ``[B]``.
    """
    cfg.check_ported()
    lin = linearize_model_taylor_batched(model, traj.mean)
    mean_post = traj.mean[..., 1:, :]
    cov_post = traj.cov[..., 1:, :, :]
    y_mean = bmv(lin.H, mean_post) + lin.d
    y_cov = bmm(bmm(lin.H, cov_post), lin.H.transpose(-1, -2)) + lin.Rp
    lls = mvn_logpdf(ys, y_mean, y_cov)
    return lls if per_step else torch.sum(lls, dim=-1)
