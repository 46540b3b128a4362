"""Batched iterated smoothers: IEKS (Taylor) and IPLS (sigma-point SLR).

The outer loop (paper §3) repeats up to M times: linearize the model
around the previous smoothed trajectory, then run one filter + smoother
pass — parallel-in-time (the paper's method, covariance or square-root
form) or sequential (baseline). Levenberg-Marquardt damping (Särkkä &
Svensson 2020) augments each measurement with a pseudo-observation of the
previous iterate with covariance ``(1/lambda) I``: fixed, or adapted per
lane from the Gauss-Newton cost (``damping="adaptive"``).

With ``tol > 0`` a per-lane active mask freezes converged trajectories and
the loop stops once every lane is done: the JAX package's ``while_loop``
becomes a Python loop that synchronizes once per pass on
``active.any()``. ``tol = 0`` runs exactly ``n_iter`` passes (the
adaptive loop still stops when every lane has diverged).

`iterated_smoother` runs one trajectory as a batch of one lane, so on the
card its scans take the combine kernels on ``[1, P]`` pair grids (the JAX
package resolves ``combine_impl="auto"`` to the textbook combines there).
`ieks`, `ipls` and `iterated_smoother_batched` are the legacy entry
points: shims that warn once and run `build_smoother` on ``ys.device``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import parallel, sequential, sqrt_parallel
from ._deprecation import warn_deprecated
from .cost import gn_cost
from .linearization import (linearize_model_slr_batched,
                            linearize_model_taylor_batched)
from .sigma_points import SCHEMES, SigmaScheme, get_scheme
from .types import (Gaussian, LinearizedSSM, StateSpaceModel, add_lane, bmm,
                    bmv, drop_lane, mvn_logpdf)

#: Axis vocabularies shared with `repro_torch.core.api.SmootherSpec` (the
#: JAX package's, value for value, so validation and ``spec_id`` agree).
FORMS = ("standard", "sqrt")
COMBINE_IMPLS = ("auto", "jnp", "fused", "pallas")
DAMPINGS = ("fixed", "adaptive")
BACKENDS = ("auto", "jnp", "tpu", "gpu")

#: `LaneStatus.code` vocabulary: the per-lane verdict of the outer loop.
LANE_CONVERGED = 0   # mean delta fell below tol (requires tol > 0)
LANE_MAX_ITERS = 1   # iteration budget exhausted while still finite
LANE_DIVERGED = 2    # non-finite iterate / cost, or damping cap exhausted

#: Adaptive Levenberg-Marquardt schedule (classic nu = 10): accepted
#: steps decay the damping, rejected steps raise it; a lane whose
#: candidates stay non-finite for LM_MAX_BAD consecutive attempts — or
#: whose damping hits the cap while still rejecting — is declared
#: diverged and frozen at its last accepted iterate.
LM_NU = 10.0
LM_LAMBDA_INIT = 1.0
LM_LAMBDA_MIN = 1e-9
LM_LAMBDA_MAX = 1e8
LM_MAX_BAD = 2


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
        if self.sigma_scheme not in SCHEMES:
            raise ValueError(
                f"unknown sigma-point scheme {self.sigma_scheme!r}; "
                f"available: {sorted(SCHEMES)}")
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

    def check_backend(self) -> None:
        """Raise for ``backend="tpu"``, which has no lowering here."""
        if self.backend == "tpu":
            raise ValueError('backend="tpu" has no lowering in the PyTorch '
                             'port; use "auto", "gpu" or "jnp"')

    def resolved_combine_impl(self, batched: bool,
                              shape: Optional[tuple] = None,
                              device=None) -> str:
        """The scan's ``combine_impl`` string for one call site —
        the JAX package's resolution table, line by line.

        ``shape`` is the launch shape ``(B, T, nx)`` when the caller knows
        it (the batched passes do) and ``device`` the device it runs on
        (``None``: the default, the card where there is one); together
        they key the ``backend="auto"`` autotune-cache lookup:

          * an explicit ``combine_impl`` wins; ``"pallas"`` is qualified
            to ``"pallas:gpu"`` when the backend forces that lowering;
          * ``"auto"`` + single trajectory -> ``"jnp"`` (textbook);
          * ``"auto"`` + batched: ``backend="jnp"`` -> ``"fused"`` (the
            plain versions); ``backend="gpu"`` -> the CUDA kernels;
            ``backend="auto"`` -> the measured winner recorded by
            `repro_torch.kernels.kalman_combine.autotune` for
            ``(model_id, B, T, nx)`` on the device's platform; an
            unmeasured site runs the kernels on the card and ``"fused"``
            on the CPU (the JAX package runs ``"fused"`` on every
            platform).
        """
        if self.combine_impl == "auto":
            if not batched:
                return "jnp"
            if self.backend in ("tpu", "gpu"):
                return f"pallas:{self.backend}"
            if self.backend == "auto":
                # Late import: kernels depend on core.
                from repro_torch.kernels.kalman_combine import \
                    autotune as kc_at
                if kc_at.decide(self.model_id, *(shape or (None,) * 3),
                                device=device) == kc_at.CHOICE_KERNEL:
                    return "pallas"
            return "fused"
        if self.combine_impl == "pallas" and self.backend in ("tpu", "gpu"):
            return f"pallas:{self.backend}"
        return self.combine_impl

    def cache_key(self, n_pad: int, b_pad: int, nx: int) -> tuple:
        """Hashable signature of one padded bucket launch: the config
        (frozen, so hashable; ``model_id`` carries the spec_id) and the
        launch shape. The service's warmup and its ``signatures_seen``
        bookkeeping key on it, as in the JAX package."""
        return (self, int(n_pad), int(b_pad), int(nx))


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


#: Legacy alias: `IterationInfo` grew lane-health fields and became
#: `LaneStatus` (same leading fields).
IterationInfo = LaneStatus


def _augment_lm(lin: LinearizedSSM, prev_means: torch.Tensor,
                lam: Union[float, torch.Tensor]
                ) -> Tuple[LinearizedSSM, torch.Tensor]:
    """LM damping: pseudo-measurement ``x_k ~ N(prev_mean_k, (1/lam) I)``.

    ``lam`` is a scalar (fixed damping) or a per-lane ``[B]`` tensor (the
    adaptive driver's independently damped lanes). Returns the augmented
    model and the pseudo measurements (the caller concatenates the real
    ys with them along the last axis).
    """
    ny, nx = lin.H.shape[-2:]
    lead = tuple(lin.H.shape[:-2])
    kw = dict(dtype=lin.H.dtype, device=lin.H.device)
    I = torch.eye(nx, **kw).expand(lead + (nx, nx))
    inv = 1.0 / torch.as_tensor(lam, dtype=lin.Rp.dtype, device=lin.Rp.device)
    inv = inv.reshape(inv.shape + (1,) * (len(lead) + 2 - inv.ndim))
    H_aug = torch.cat([lin.H, I], dim=-2)
    d_aug = torch.cat([lin.d, torch.zeros(lead + (nx,), **kw)], dim=-1)
    R_pad = torch.zeros(lead + (ny, nx), **kw)
    R_top = torch.cat([lin.Rp, R_pad], dim=-1)
    R_bot = torch.cat([R_pad.transpose(-1, -2), I * inv], dim=-1)
    Rp_aug = torch.cat([R_top, R_bot], dim=-2)
    return LinearizedSSM(F=lin.F, c=lin.c, Qp=lin.Qp,
                         H=H_aug, d=d_aug, Rp=Rp_aug), prev_means


def _scheme_for(model: StateSpaceModel, cfg: IteratedConfig
                ) -> Optional[SigmaScheme]:
    return (get_scheme(cfg.sigma_scheme, model.nx)
            if cfg.method == "slr" else None)


def _linearize(model: StateSpaceModel, traj: Gaussian, cfg: IteratedConfig,
               scheme: Optional[SigmaScheme]) -> LinearizedSSM:
    if cfg.method == "ekf":
        return linearize_model_taylor_batched(model, traj.mean)
    return linearize_model_slr_batched(model, traj, scheme, cfg.jitter)


def _one_pass_batched(model: StateSpaceModel, ys: torch.Tensor,
                      traj: Gaussian, cfg: IteratedConfig,
                      scheme: Optional[SigmaScheme],
                      lam: Optional[torch.Tensor] = None) -> Gaussian:
    """One linearize->filter->smooth pass over ``[B, n]`` trajectories.

    ``lam`` (per-lane ``[B]``) overrides ``cfg.lm_lambda`` — the adaptive
    driver damps each lane independently."""
    lin = _linearize(model, traj, cfg, scheme)
    if lam is None and cfg.lm_lambda > 0.0:
        lam = cfg.lm_lambda
    ys_eff = ys
    if lam is not None:
        lin, pseudo = _augment_lm(lin, traj.mean[:, 1:], lam)
        ys_eff = torch.cat([ys, pseudo], dim=-1)
    if not cfg.parallel:
        _, smoothed = sequential._filter_smoother_batched(
            lin, ys_eff, model.m0, model.P0)
    elif cfg.form == "sqrt":
        _, smoothed = sqrt_parallel._sqrt_parallel_filter_smoother_batched(
            lin, ys_eff, model.m0, model.P0)
    else:
        _, smoothed = parallel._parallel_filter_smoother_batched(
            lin, ys_eff, model.m0, model.P0,
            combine_impl=cfg.resolved_combine_impl(
                batched=True,
                shape=(ys.shape[0], ys.shape[1], traj.mean.shape[-1]),
                device=ys.device))
    return smoothed


def initial_trajectory(model: StateSpaceModel, n: int) -> Gaussian:
    """Nominal initialization of one trajectory: the prior tiled along
    its ``n + 1`` states, on the model's device."""
    return drop_lane(initial_trajectory_batched(model, 1, n))


def initial_trajectory_batched(model: StateSpaceModel, B: int, n: int
                               ) -> Gaussian:
    """Nominal initialization: the prior tiled along every trajectory."""
    mean = model.m0.expand((B, n + 1) + tuple(model.m0.shape))
    cov = model.P0.expand((B, n + 1) + tuple(model.P0.shape))
    return Gaussian(mean=mean, cov=cov)


def _pack_result(traj, hist, M, info, return_history, return_info):
    """``traj`` and, as asked, the mean history ``[M, B, n+1, nx]`` (the
    list ``hist`` of executed passes; later rows repeat the final mean)
    and the info."""
    out = (traj,)
    if return_history:
        out = out + (torch.stack(hist + [traj.mean] * (M - len(hist))),)
    if return_info:
        out = out + (info,)
    return out[0] if len(out) == 1 else out


def _mean_delta(new: Gaussian, old: Gaussian) -> torch.Tensor:
    return torch.amax(torch.abs(new.mean - old.mean), dim=(1, 2))


def _finite_lanes(traj: Gaussian) -> torch.Tensor:
    """Per-lane all-finite check over means and covariances (``[B]``)."""
    return (torch.isfinite(traj.mean).all(dim=(1, 2))
            & torch.isfinite(traj.cov).all(dim=(1, 2, 3)))


def _make_info(model, ys, traj, cfg, scheme, iterations, delta, converged,
               want_cost: bool) -> LaneStatus:
    """Final `LaneStatus` of the fixed-damping drivers: classify each lane
    from its finiteness and convergence flag; evaluate the GN cost only
    when asked."""
    finite = _finite_lanes(traj)
    if want_cost:
        cost = gn_cost(model, ys, traj, cfg.method, scheme, cfg.jitter)
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


def _adaptive_iterated(model: StateSpaceModel, ys: torch.Tensor,
                       cfg: IteratedConfig, scheme: Optional[SigmaScheme],
                       traj0: Gaussian, return_history: bool,
                       return_info: bool):
    """Per-lane adaptive Levenberg-Marquardt outer loop.

    Every pass runs one damped pass for all lanes, evaluates the GN cost
    of each candidate under its own linearization, and then — per lane,
    independently — accepts the step (cost did not rise: damping decays
    by `LM_NU`), rejects it (the lane keeps its previous iterate and
    raises its damping), or declares divergence (`LM_MAX_BAD` consecutive
    non-finite candidates, or the damping cap reached while still
    rejecting) and freezes the lane at its last accepted, hence finite,
    iterate. A lane that never accepts returns the initial trajectory.
    ``cfg.lm_lambda > 0`` seeds the damping, otherwise `LM_LAMBDA_INIT`.
    The loop synchronizes once per pass, on ``active.any()``.
    """
    M = cfg.n_iter
    B = traj0.mean.shape[0]
    kw = dict(dtype=traj0.mean.dtype, device=traj0.mean.device)
    lanes_i32 = dict(dtype=torch.int32, device=traj0.mean.device)
    lam = torch.full((B,), cfg.lm_lambda if cfg.lm_lambda > 0.0
                     else LM_LAMBDA_INIT, **kw)
    cost = gn_cost(model, ys, traj0, cfg.method, scheme, cfg.jitter)
    # A NaN initial cost (NaN observations) can never win a comparison:
    # mark the lane diverged up front instead of burning its budget.
    active = ~torch.isnan(cost)
    code = torch.where(active, LANE_MAX_ITERS, LANE_DIVERGED
                       ).to(torch.int32)
    iters = torch.zeros((B,), **lanes_i32)
    bad = torch.zeros((B,), **lanes_i32)
    delta = torch.full((B,), math.inf, **kw)
    traj, hist = traj0, []
    it = 0
    while it < M and bool(active.any()):
        cand = _one_pass_batched(model, ys, traj, cfg, scheme, lam=lam)
        cand_cost = gn_cost(model, ys, cand, cfg.method, scheme, cfg.jitter)
        cand_finite = _finite_lanes(cand) & torch.isfinite(cand_cost)
        accept = active & cand_finite & (cand_cost <= cost)
        step_delta = _mean_delta(cand, traj)
        traj = _freeze_lanes(accept, cand, traj)
        cost = torch.where(accept, cand_cost, cost)
        delta = torch.where(accept, step_delta, delta)
        lam = torch.where(
            accept, torch.clamp(lam / LM_NU, min=LM_LAMBDA_MIN),
            torch.where(active, torch.clamp(lam * LM_NU, max=LM_LAMBDA_MAX),
                        lam))
        bad = torch.where(accept, 0, torch.where(active, bad + 1, bad))
        iters = iters + active.to(torch.int32)
        if cfg.tol > 0.0:
            conv = accept & (step_delta <= cfg.tol)
        else:
            conv = torch.zeros_like(accept)
        hopeless = active & ~accept & (
            (~cand_finite & (bad >= LM_MAX_BAD)) | (lam >= LM_LAMBDA_MAX))
        code = torch.where(conv, LANE_CONVERGED,
                           torch.where(hopeless, LANE_DIVERGED, code)
                           ).to(torch.int32)
        active = active & ~conv & ~hopeless
        if return_history:
            hist.append(traj.mean)
        it += 1
    info = LaneStatus(iterations=iters, final_delta=delta, code=code,
                      final_cost=cost)
    return _pack_result(traj, hist, M, info, return_history, return_info)


def _iterated_smoother_batched(model: StateSpaceModel, ys: torch.Tensor,
                               cfg: IteratedConfig = IteratedConfig(),
                               init: Optional[Gaussian] = None,
                               return_history: bool = False,
                               return_info: bool = False):
    """Batched iterated smoother over ``ys [B, n, ny]``.

    Every pass runs all B trajectories through one batched
    filter+smoother; with ``cfg.tol > 0`` converged lanes freeze
    (``info.iterations`` records per-lane pass counts) and the loop exits
    once every lane has converged. Returns ``[B, n+1, ...]`` marginals,
    then as asked the mean history ``[M, B, n+1, nx]`` and a `LaneStatus`.
    """
    cfg.check_backend()
    B, n = ys.shape[:2]
    traj = init if init is not None else initial_trajectory_batched(
        model, B, n)
    scheme = _scheme_for(model, cfg)
    M = cfg.n_iter
    dev = ys.device

    if cfg.damping == "adaptive":
        return _adaptive_iterated(model, ys, cfg, scheme, traj,
                                  return_history, return_info)

    hist = []
    if cfg.tol <= 0.0:
        for _ in range(M):
            new = _one_pass_batched(model, ys, traj, cfg, scheme)
            delta = _mean_delta(new, traj)
            traj = new
            if return_history:
                hist.append(traj.mean)
        info = _make_info(model, ys, traj, cfg, scheme,
                          iterations=torch.full((B,), M, dtype=torch.int32,
                                                device=dev),
                          delta=delta,
                          converged=torch.zeros((B,), dtype=torch.bool,
                                                device=dev),
                          want_cost=return_info)
        return _pack_result(traj, hist, M, info, return_history,
                            return_info)

    active = torch.ones((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    delta = torch.full((B,), math.inf, dtype=traj.mean.dtype, device=dev)
    it = 0
    while it < M and bool(active.any()):
        new = _one_pass_batched(model, ys, traj, cfg, scheme)
        new = _freeze_lanes(active, new, traj)
        step_delta = _mean_delta(new, traj)
        delta = torch.where(active, step_delta, delta)
        iters = iters + active.to(torch.int32)
        active = active & (step_delta > cfg.tol)
        traj = new
        if return_history:
            hist.append(traj.mean)
        it += 1
    info = _make_info(model, ys, traj, cfg, scheme, iterations=iters,
                      delta=delta, converged=delta <= cfg.tol,
                      want_cost=return_info)
    return _pack_result(traj, hist, M, info, return_history, return_info)


def iterated_smoother(model: StateSpaceModel, ys: torch.Tensor,
                      cfg: IteratedConfig = IteratedConfig(),
                      init: Optional[Gaussian] = None,
                      return_history: bool = False,
                      return_info: bool = False):
    """Run up to ``cfg.n_iter`` linearize->filter->smooth passes over one
    trajectory ``ys [n, ny]``: the batched driver on one lane.

    Returns the smoothed trajectory ``[n+1, ...]``; then, as asked, the
    mean history ``[M, n+1, nx]`` (rows past the executed passes repeat
    the final mean) and the `LaneStatus` with scalar fields.
    """
    out = _iterated_smoother_batched(
        model, ys[None], cfg, init=None if init is None else add_lane(init),
        return_history=return_history, return_info=return_info)
    if not (return_history or return_info):
        return drop_lane(out)
    out = list(out)
    out[0] = drop_lane(out[0])
    if return_history:
        out[1] = out[1][:, 0]
    if return_info:
        out[-1] = drop_lane(out[-1])
    return tuple(out)


def smoothed_log_likelihood(model: StateSpaceModel, ys: torch.Tensor,
                            traj: Gaussian,
                            cfg: IteratedConfig = IteratedConfig(),
                            per_step: bool = False) -> torch.Tensor:
    """Measurement log-likelihood under the smoothed posterior.

    Each step's observation is scored against its posterior predictive
    under the linearization at ``traj`` of the family the smoother
    iterated with (``cfg.method``/``cfg.sigma_scheme``):
    ``y_k ~ N(H_k m_k + d_k, H_k P_k H_k^T + Rp_k)``, summed over time
    (``per_step=True`` returns the per-step terms — serving masks padded
    steps before summing). ``ys [n, ny]`` with ``traj [n+1, ...]`` gives a
    scalar (run as one lane); ``ys [B, n, ny]`` gives ``[B]``.
    """
    if ys.ndim == 2:
        return smoothed_log_likelihood(model, ys[None], add_lane(traj), cfg,
                                       per_step)[0]
    cfg.check_backend()
    lin = _linearize(model, traj, cfg, _scheme_for(model, cfg))
    mean_post = traj.mean[..., 1:, :]
    cov_post = traj.cov[..., 1:, :, :]
    y_mean = bmv(lin.H, mean_post) + lin.d
    y_cov = bmm(bmm(lin.H, cov_post), lin.H.transpose(-1, -2)) + lin.Rp
    lls = mvn_logpdf(ys, y_mean, y_cov)
    return lls if per_step else torch.sum(lls, dim=-1)


# ---------------------------------------------------------------------------
# Legacy entry points (delegating shims; warn once per process)
# ---------------------------------------------------------------------------

def iterated_smoother_batched(model, ys,
                              cfg: IteratedConfig = IteratedConfig(),
                              init=None, return_history: bool = False,
                              return_info: bool = False):
    """Deprecated: `build_smoother(spec).iterate` dispatches single vs
    batched from ``ys.ndim``. Runs on ``ys.device``."""
    from .api import SmootherSpec, build_smoother
    warn_deprecated("iterated_smoother_batched",
                    "build_smoother(SmootherSpec(...)).iterate(model, ys)")
    return build_smoother(SmootherSpec.from_iterated_config(cfg),
                          device=ys.device).iterate(
        model, ys, init=init, return_history=return_history,
        return_info=return_info)


def ieks(model, ys, n_iter: int = 10, parallel_mode: bool = True, **kw):
    """Deprecated alias for the paper's IEKS: Taylor linearization
    through `build_smoother`, on ``ys.device``."""
    from .api import SmootherSpec, build_smoother
    warn_deprecated(
        "ieks", 'build_smoother(SmootherSpec(linearization="taylor", '
        '...)).iterate(model, ys)')
    cfg = IteratedConfig(method="ekf", n_iter=n_iter, parallel=parallel_mode,
                         **kw)
    return build_smoother(SmootherSpec.from_iterated_config(cfg),
                          device=ys.device).iterate(model, ys)


def ipls(model, ys, n_iter: int = 10, parallel_mode: bool = True,
         sigma_scheme: str = "cubature", **kw):
    """Deprecated alias for the paper's IPLS: sigma-point SLR
    linearization through `build_smoother`, on ``ys.device``."""
    from .api import SmootherSpec, build_smoother
    warn_deprecated(
        "ipls", 'build_smoother(SmootherSpec(linearization="slr", '
        '...)).iterate(model, ys)')
    cfg = IteratedConfig(method="slr", n_iter=n_iter, parallel=parallel_mode,
                         sigma_scheme=sigma_scheme, **kw)
    return build_smoother(SmootherSpec.from_iterated_config(cfg),
                          device=ys.device).iterate(model, ys)
