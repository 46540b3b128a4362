"""Sequential Kalman filter and RTS smoother over ``[B, n]`` trajectories.

The paper's sequential baseline (span O(n)): one Python loop over time
carrying all B lanes, so each step is ``[B, ...]`` vectorized work. It is
``mode="sequential"`` and, on the card, the full-width oracle of the
parallel path that shares no algebra with the combines (LU solves and
matmuls instead of Gauss-Jordan and the Eq. 15/19 combines). The
single-trajectory drivers are the batched ones on one lane.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .types import (Gaussian, LinearizedSSM, add_lane,
                    bcast_prior as _bcast_prior, drop_lane, mvn_logpdf,
                    solve, symmetrize)


def _T(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def kalman_filter_batched(lin: LinearizedSSM, ys: torch.Tensor,
                          m0: torch.Tensor, P0: torch.Tensor,
                          return_loglik: bool = False):
    """Sequential Kalman filter over ``[B, n]`` trajectories.

    ``lin`` leaves and ``ys`` carry a leading batch axis; ``m0``/``P0``
    may be shared or per-lane. Returns filtered ``[B, n, ...]`` (and the
    per-lane log-likelihood ``[B]`` when requested).
    """
    B, n = ys.shape[:2]
    m, P = _bcast_prior(m0, B, 1), _bcast_prior(P0, B, 2)
    ms, Ps, lls = [], [], []
    for k in range(n):
        F, c, Qp = lin.F[:, k], lin.c[:, k], lin.Qp[:, k]
        H, d, Rp = lin.H[:, k], lin.d[:, k], lin.Rp[:, k]
        m_pred = _mv(F, m) + c
        P_pred = symmetrize(F @ P @ _T(F) + Qp)
        S = symmetrize(H @ P_pred @ _T(H) + Rp)
        y_pred = _mv(H, m_pred) + d
        K = _T(solve(S, H @ P_pred))
        m = m_pred + _mv(K, ys[:, k] - y_pred)
        P = symmetrize(P_pred - K @ S @ _T(K))
        ms.append(m)
        Ps.append(P)
        if return_loglik:
            lls.append(mvn_logpdf(ys[:, k], y_pred, S))
    out = Gaussian(mean=torch.stack(ms, dim=1), cov=torch.stack(Ps, dim=1))
    if return_loglik:
        return out, torch.stack(lls, dim=1).sum(dim=1)
    return out


def rts_smoother_batched(lin: LinearizedSSM, filtered: Gaussian,
                         m0: torch.Tensor, P0: torch.Tensor) -> Gaussian:
    """Sequential RTS smoother over ``[B, n]`` lanes (one reverse loop).

    Returns smoothed posteriors for ``x_0..x_n`` (``[B, n+1, ...]``); row
    0 smooths the prior through the first transition.
    """
    B, n = filtered.mean.shape[:2]
    m_f = torch.cat([_bcast_prior(m0, B, 1)[:, None], filtered.mean[:, :-1]],
                    dim=1)
    P_f = torch.cat([_bcast_prior(P0, B, 2)[:, None], filtered.cov[:, :-1]],
                    dim=1)
    m_s, P_s = filtered.mean[:, -1], filtered.cov[:, -1]
    ms, Ps = [m_s], [P_s]
    for k in range(n - 1, -1, -1):
        F, c, Qp = lin.F[:, k], lin.c[:, k], lin.Qp[:, k]
        mf, Pf = m_f[:, k], P_f[:, k]
        m_pred = _mv(F, mf) + c
        P_pred = symmetrize(F @ Pf @ _T(F) + Qp)
        G = _T(solve(P_pred, F @ Pf))           # P_f F^T P_pred^{-1}
        m_s = mf + _mv(G, m_s - m_pred)
        P_s = symmetrize(Pf + G @ (P_s - P_pred) @ _T(G))
        ms.append(m_s)
        Ps.append(P_s)
    return Gaussian(mean=torch.stack(ms[::-1], dim=1),
                    cov=torch.stack(Ps[::-1], dim=1))


def _filter_smoother_batched(lin: LinearizedSSM, ys: torch.Tensor,
                             m0: torch.Tensor, P0: torch.Tensor
                             ) -> Tuple[Gaussian, Gaussian]:
    """One batched sequential pass. Smoothed has shape ``[B, n+1, ...]``."""
    filtered = kalman_filter_batched(lin, ys, m0, P0)
    smoothed = rts_smoother_batched(lin, filtered, m0, P0)
    return filtered, smoothed


def filter_smoother_batched(lin: LinearizedSSM, ys: torch.Tensor,
                            m0: torch.Tensor, P0: torch.Tensor
                            ) -> Tuple[Gaussian, Gaussian]:
    """Deprecated: `build_smoother(spec).smooth` dispatches single vs
    batched from ``ys.ndim``. Runs on ``ys.device``."""
    from ._deprecation import warn_deprecated
    from .api import build_smoother
    warn_deprecated(
        "filter_smoother_batched",
        'build_smoother(mode="sequential").smooth(lin, ys, m0, P0)')
    return build_smoother(mode="sequential", device=ys.device).smooth(
        lin, ys, m0, P0)


# ---------------------------------------------------------------------------
# Single-trajectory drivers: the batched ones on one lane
# ---------------------------------------------------------------------------

def kalman_filter(lin: LinearizedSSM, ys: torch.Tensor, m0: torch.Tensor,
                  P0: torch.Tensor, return_loglik: bool = False):
    """Sequential (extended/SLR) Kalman filter of one trajectory.

    ``lin`` leaves have leading dim n, ``ys [n, ny]`` (row k-1 is
    ``y_k``). Returns the filtered posteriors of ``x_1..x_n`` and, when
    asked, the total data log-likelihood under the linearized model (a
    scalar)."""
    out = kalman_filter_batched(add_lane(lin), ys[None], m0, P0,
                                return_loglik=return_loglik)
    if return_loglik:
        return drop_lane(out[0]), out[1][0]
    return drop_lane(out)


def rts_smoother(lin: LinearizedSSM, filtered: Gaussian, m0: torch.Tensor,
                 P0: torch.Tensor) -> Gaussian:
    """Sequential Rauch-Tung-Striebel smoother of one trajectory: smoothed
    posteriors of ``x_0..x_n`` (leading dim n+1)."""
    return drop_lane(rts_smoother_batched(add_lane(lin), add_lane(filtered),
                                          m0, P0))


def filter_smoother(lin: LinearizedSSM, ys: torch.Tensor, m0: torch.Tensor,
                    P0: torch.Tensor) -> Tuple[Gaussian, Gaussian]:
    """One sequential filtering + smoothing pass of one trajectory.
    Smoothed has leading dim n+1."""
    filtered, smoothed = _filter_smoother_batched(add_lane(lin), ys[None],
                                                  m0, P0)
    return drop_lane(filtered), drop_lane(smoothed)
