"""First-order Taylor linearization (IEKS) of a nonlinear SSM.

For a map ``phi`` and a nominal point ``m``: ``phi(x) ~= F x + c`` with
``F = d phi/dx (m)`` (``torch.func.jacfwd``) and ``c = phi(m) - F m``
(paper Eq. 10; the residual covariance is zero). The batched form
linearizes all ``B*n`` rows of a fleet with one ``torch.func.vmap`` per
map. Sigma-point SLR is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .types import LinearizedSSM, StateSpaceModel, bmv

AffineParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (F, c, Lambda)


def _value_and_jacobian(phi: Callable) -> Callable:
    def with_aux(m):
        z = phi(m)
        return z, z
    return torch.func.jacfwd(with_aux, has_aux=True)


def linearize_taylor(phi: Callable, m: torch.Tensor, P: torch.Tensor = None
                     ) -> AffineParams:
    """First-order Taylor linearization at ``m`` (covariance unused)."""
    del P
    F, z = _value_and_jacobian(phi)(m)
    c = z - (F @ m[..., None])[..., 0]
    Lam = torch.zeros((z.shape[-1], z.shape[-1]), dtype=m.dtype,
                      device=m.device)
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
