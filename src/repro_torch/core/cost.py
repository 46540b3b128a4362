"""Gauss-Newton smoothing cost: the objective the iterated smoothers descend.

Under the linearization ``(F, c, Qp, H, d, Rp)`` at the current trajectory:

    J(m) = 1/2 |m_0 - m0|^2_{P0^-1}
         + 1/2 sum_k |m_{k+1} - F_k m_k - c_k|^2_{Qp_k^-1}
         + 1/2 sum_k |y_k - H_k m_{k+1} - d_k|^2_{Rp_k^-1}

Shape-polymorphic over one leading lane axis: ``means [n+1, nx]`` gives a
scalar, ``[B, n+1, nx]`` gives ``[B]`` per-lane costs (never reduced
across lanes).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .linearization import (linearize_model_slr_batched,
                            linearize_model_taylor_batched)
from .sigma_points import SigmaScheme, get_scheme
from .types import (Gaussian, LinearizedSSM, StateSpaceModel, add_lane, bmv,
                    cholesky)


def _half_quad(diff: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """``1/2 diff^T cov^-1 diff`` over the last axis (Cholesky solve)."""
    chol = cholesky(cov)
    z = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
    return 0.5 * torch.sum(z * z, dim=-1)


def smoothing_cost(lin: LinearizedSSM, ys: torch.Tensor, means: torch.Tensor,
                   m0: torch.Tensor, P0: torch.Tensor) -> torch.Tensor:
    """GN/MAP cost of a mean trajectory under a linearized model."""
    prev = means[..., :-1, :]
    nxt = means[..., 1:, :]
    prior_res = means[..., 0, :] - m0
    trans_res = nxt - bmv(lin.F, prev) - lin.c
    meas_res = ys - bmv(lin.H, nxt) - lin.d
    return (_half_quad(prior_res, P0.expand(prior_res.shape[:-1] + P0.shape[-2:]))
            + torch.sum(_half_quad(trans_res, lin.Qp), dim=-1)
            + torch.sum(_half_quad(meas_res, lin.Rp), dim=-1))


def gn_cost(model: StateSpaceModel, ys: torch.Tensor, traj: Gaussian,
            method: str = "ekf",
            scheme: Optional[Union[SigmaScheme, str]] = None,
            jitter: float = 0.0) -> torch.Tensor:
    """Linearize ``model`` at ``traj`` (Taylor for ``method="ekf"``, SLR
    for ``"slr"``) and evaluate :func:`smoothing_cost` at its means: a
    scalar for ``ys [n, ny]`` with ``traj [n+1, ...]`` (run as one lane),
    ``[B]`` for ``ys [B, n, ny]``. ``scheme`` may be a `SigmaScheme` or a
    scheme name (resolved against ``model.nx``); it defaults to cubature
    for SLR."""
    if ys.ndim == 2:
        return gn_cost(model, ys[None], add_lane(traj), method, scheme,
                       jitter)[0]
    if method == "ekf":
        lin = linearize_model_taylor_batched(model, traj.mean)
    elif method == "slr":
        if scheme is None or isinstance(scheme, str):
            scheme = get_scheme(scheme or "cubature", model.nx)
        lin = linearize_model_slr_batched(model, traj, scheme, jitter)
    else:
        raise ValueError(f"unknown method {method!r}")
    return smoothing_cost(lin, ys, traj.mean, model.m0, model.P0)
