"""Sigma-point schemes for statistical linear regression (paper Eq. 7-9).

Each scheme maps a Gaussian ``N(m, P)`` to points ``X [s, nx]`` and
weights ``w [s]`` such that moment-matched expectations are weighted sums
over transformed points. The paper's experiments use the cubature rule
(spherical-radial, 2*nx points); unscented and Gauss-Hermite complete the
IPLS family. Unit points and weights are built in numpy, value for value
as the JAX package builds them, and become tensors on the caller's device
and dtype in :meth:`SigmaScheme.points`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .types import cholesky, symmetrize


def _safe_cholesky(P: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower factor of ``sym(P) (+ jitter I)``; NaN where ``P`` is not
    positive definite (as ``jnp.linalg.cholesky``), never a raise."""
    if jitter:
        P = P + jitter * torch.eye(P.shape[-1], dtype=P.dtype,
                                   device=P.device)
    return cholesky(symmetrize(P))


@dataclasses.dataclass(frozen=True)
class SigmaScheme:
    """Unit sigma points ``xi [s, nx]`` and weights ``wm, wc [s]``.

    Points for ``N(m, P)`` are ``m + chol(P) @ xi_j``.
    """

    xi: np.ndarray
    wm: np.ndarray
    wc: np.ndarray

    @property
    def num_points(self) -> int:
        return self.xi.shape[0]

    def points(self, m: torch.Tensor, P: torch.Tensor, jitter: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Points ``[..., s, nx]`` of ``N(m [..., nx], P [..., nx, nx])``
        and the weights ``wm, wc [s]`` in ``m``'s dtype and device."""
        kw = dict(dtype=m.dtype, device=m.device)
        chol = _safe_cholesky(P, jitter)
        xi = torch.as_tensor(self.xi, **kw)
        pts = m[..., None, :] + xi @ chol.transpose(-1, -2)
        return (pts, torch.as_tensor(self.wm, **kw),
                torch.as_tensor(self.wc, **kw))


def cubature(nx: int) -> SigmaScheme:
    """Third-degree spherical-radial cubature rule: 2*nx points (paper §5)."""
    s = np.sqrt(float(nx))
    xi = np.concatenate([s * np.eye(nx), -s * np.eye(nx)], axis=0)
    w = np.full((2 * nx,), 1.0 / (2 * nx))
    return SigmaScheme(xi=xi, wm=w, wc=w)


def unscented(nx: int, alpha: float = 1.0, beta: float = 0.0,
              kappa: float = None) -> SigmaScheme:
    """Standard UKF points: 2*nx + 1 points."""
    if kappa is None:
        kappa = 3.0 - nx
    lam = alpha * alpha * (nx + kappa) - nx
    s = np.sqrt(nx + lam)
    xi = np.concatenate([np.zeros((1, nx)), s * np.eye(nx), -s * np.eye(nx)],
                        axis=0)
    wm = np.full((2 * nx + 1,), 1.0 / (2.0 * (nx + lam)))
    wc = wm.copy()
    wm[0] = lam / (nx + lam)
    wc[0] = lam / (nx + lam) + (1.0 - alpha * alpha + beta)
    return SigmaScheme(xi=xi, wm=wm, wc=wc)


def gauss_hermite(nx: int, order: int = 3) -> SigmaScheme:
    """Gauss-Hermite product rule: ``order**nx`` points (small nx only)."""
    pts1, w1 = np.polynomial.hermite_e.hermegauss(order)
    w1 = w1 / np.sqrt(2.0 * np.pi)  # probabilists' normalization
    # hermegauss is w.r.t. exp(-x^2/2); weights sum to sqrt(2 pi).
    w1 = w1 / w1.sum()
    grids = np.meshgrid(*([pts1] * nx), indexing="ij")
    xi = np.stack([g.reshape(-1) for g in grids], axis=-1)
    wgrids = np.meshgrid(*([w1] * nx), indexing="ij")
    w = np.ones(xi.shape[0])
    for g in wgrids:
        w = w * g.reshape(-1)
    return SigmaScheme(xi=xi, wm=w, wc=w)


SCHEMES = {
    "cubature": cubature,
    "unscented": unscented,
    "gauss_hermite": gauss_hermite,
}


def get_scheme(name: str, nx: int, **kwargs) -> SigmaScheme:
    try:
        return SCHEMES[name](nx, **kwargs)
    except KeyError as e:
        raise ValueError(f"unknown sigma-point scheme {name!r}; "
                         f"available: {sorted(SCHEMES)}") from e
