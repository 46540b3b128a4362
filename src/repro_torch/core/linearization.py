"""Linearization strategies: first-order Taylor (IEKS) and sigma-point
SLR (IPLS).

Both produce, for a nonlinear map ``phi`` and a linearization Gaussian
``N(m, P)``, an affine-Gaussian approximation
``phi(x) ~= F x + c + e, e ~ N(0, Lambda)``.

Taylor (paper Eq. 10): ``F = d phi/dx (m)`` (``torch.func.jacfwd``),
``c = phi(m) - F m``, ``Lambda = 0``. Sigma-point SLR (paper Eq. 7-9):
moment-matched regression through transformed sigma points; ``Lambda`` is
the SLR residual covariance. The batched forms linearize all ``B*n`` rows
of a fleet at once: one ``torch.func.vmap`` per map over the rows
(Taylor) or over all ``B*n*s`` sigma points (SLR); the single-trajectory
forms are the batched ones on one lane.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .sigma_points import SigmaScheme
from .types import (Gaussian, LinearizedSSM, StateSpaceModel, add_lane, bmv,
                    drop_lane, solve, symmetrize)

AffineParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (F, c, Lambda)


def _value_and_jacobian(phi: Callable) -> Callable:
    """``m -> (d phi/dx (m), phi(m))``, the Jacobian in ``m``'s dtype.

    Forward-mode AD promotes the tangent of a 0-d tensor times a Python
    float to float64 (``x[0] * 2.0`` under ``jacfwd``), so a float32 model
    written with Python constants would get a float64 Jacobian; it is cast
    back, as JAX's ``jacfwd`` keeps the primal's dtype."""
    def with_aux(m):
        z = phi(m)
        return z, z
    jac = torch.func.jacfwd(with_aux, has_aux=True)

    def value_and_jacobian(m):
        F, z = jac(m)
        return F.to(m.dtype), z
    return value_and_jacobian


def linearize_taylor(phi: Callable, m: torch.Tensor, P: torch.Tensor = None
                     ) -> AffineParams:
    """First-order Taylor linearization at ``m`` (covariance unused)."""
    del P
    F, z = _value_and_jacobian(phi)(m)
    c = z - (F @ m[..., None])[..., 0]
    Lam = torch.zeros((z.shape[-1], z.shape[-1]), dtype=m.dtype,
                      device=m.device)
    return F, c, Lam


def linearize_slr(phi: Callable, m: torch.Tensor, P: torch.Tensor,
                  scheme: SigmaScheme, jitter: float = 0.0) -> AffineParams:
    """Sigma-point statistical linear regression (paper Eq. 7-9) of
    ``phi`` under ``N(m [..., nx], P [..., nx, nx])``, batched over the
    leading axes: one vmap of ``phi`` over every sigma point."""
    pts, wm, wc = scheme.points(m, P, jitter)        # [..., s, nx]
    lead = tuple(pts.shape[:-1])
    Z = torch.func.vmap(phi)(pts.reshape(-1, pts.shape[-1]))
    Z = Z.reshape(lead + Z.shape[-1:])               # [..., s, nz]
    zbar = torch.einsum("s,...sz->...z", wm, Z)
    dx = pts - m[..., None, :]
    dz = Z - zbar[..., None, :]
    Psi = torch.einsum("s,...sx,...sz->...xz", wc, dx, dz)   # cov(x, z)
    Phi = torch.einsum("s,...sz,...sw->...zw", wc, dz, dz)   # cov(z, z)
    # F = Psi^T P^{-1} (solve with the *sampled* P for consistency).
    Ps = symmetrize(P)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    F = solve(Ps + jitter * eye, Psi).transpose(-1, -2)
    c = zbar - bmv(F, m)
    Lam = symmetrize(Phi - F @ Ps @ F.transpose(-1, -2))
    return F, c, Lam


def broadcast_noise_batched(M: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """Broadcast process/measurement noise to a ``[B, n, d, d]`` stack.

    Accepts shared ``[d, d]``, per-step ``[n, d, d]``, or per-lane
    ``[B, n, d, d]`` (serving's time padding inflates R per lane/step).
    """
    if M.ndim == 2:
        return M.expand((B, n) + tuple(M.shape))
    if M.ndim == 3:
        if M.shape[0] != n:
            raise ValueError(f"noise stack has length {M.shape[0]}, "
                             f"expected {n}")
        return M.expand((B,) + tuple(M.shape))
    if tuple(M.shape[:2]) != (B, n):
        raise ValueError(f"batched noise stack is {tuple(M.shape[:2])}, "
                         f"expected {(B, n)}")
    return M


def _rows_linearized(phi: Callable, rows: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(F, c)`` of ``phi`` at every row of ``rows [N, nx]``."""
    F, z = torch.func.vmap(_value_and_jacobian(phi))(rows)
    return F, z - bmv(F, rows)


def linearize_model_taylor_batched(model: StateSpaceModel,
                                   traj_means: torch.Tensor) -> LinearizedSSM:
    """Taylor-linearize around ``B`` nominal trajectories ``[B, n+1, nx]``.

    All ``B*n`` Jacobians per map come from one flattened vmap call;
    returns a `LinearizedSSM` whose leaves carry a leading batch axis.
    """
    B, np1, nx = traj_means.shape
    n = np1 - 1
    Fs, cs = _rows_linearized(model.f, traj_means[:, :-1].reshape(-1, nx))
    Hs, ds = _rows_linearized(model.h, traj_means[:, 1:].reshape(-1, nx))
    unflat = lambda x: x.reshape((B, n) + x.shape[1:])  # noqa: E731
    return LinearizedSSM(
        F=unflat(Fs), c=unflat(cs),
        Qp=broadcast_noise_batched(model.Q, B, n),
        H=unflat(Hs), d=unflat(ds),
        Rp=broadcast_noise_batched(model.R, B, n))


def linearize_model_slr_batched(model: StateSpaceModel, traj: Gaussian,
                                scheme: SigmaScheme, jitter: float = 0.0
                                ) -> LinearizedSSM:
    """SLR-linearize around ``B`` smoothed trajectories
    ``traj = Gaussian(means [B, n+1, nx], covs [B, n+1, nx, nx])``.

    The residual covariances are added to the noise, so ``Qp``/``Rp`` are
    per-row ``[B, n, d, d]`` stacks (never broadcast views)."""
    B, np1 = traj.mean.shape[:2]
    n = np1 - 1
    Fs, cs, Lams = linearize_slr(model.f, traj.mean[:, :-1],
                                 traj.cov[:, :-1], scheme, jitter)
    Hs, ds, Oms = linearize_slr(model.h, traj.mean[:, 1:], traj.cov[:, 1:],
                                scheme, jitter)
    Q = broadcast_noise_batched(model.Q, B, n) + Lams
    R = broadcast_noise_batched(model.R, B, n) + Oms
    return LinearizedSSM(F=Fs, c=cs, Qp=symmetrize(Q), H=Hs, d=ds,
                         Rp=symmetrize(R))


def linearize_model_taylor(model: StateSpaceModel, traj_means: torch.Tensor
                           ) -> LinearizedSSM:
    """Taylor-linearize around one nominal trajectory ``[n+1, nx]``:
    a `LinearizedSSM` with leading dim n."""
    return drop_lane(linearize_model_taylor_batched(model,
                                                    traj_means[None]))


def linearize_model_slr(model: StateSpaceModel, traj: Gaussian,
                        scheme: SigmaScheme, jitter: float = 0.0
                        ) -> LinearizedSSM:
    """SLR-linearize around one smoothed trajectory ``traj =
    Gaussian(means [n+1, nx], covs [n+1, nx, nx])``."""
    return drop_lane(linearize_model_slr_batched(model, add_lane(traj),
                                                 scheme, jitter))
