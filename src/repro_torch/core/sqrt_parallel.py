"""Square-root (Cholesky-factor) parallel filtering and smoothing.

The paper's combines propagate covariances ``C`` and information matrices
``J`` directly; long products of Eq. 15 lose positive definiteness in
float32. This module propagates *factors* ``U`` (``C = U Uᵀ``), ``Z``
(``J = Z Zᵀ``) and ``D`` (``L = D Dᵀ``) instead, with every update a QR
triangularization — the square-root filter lifted to the parallel
combine:

  filtering element  a_k = (A, b, U, eta, Z)
  smoothing element  a_k = (E, g, D)

Combine identities (Woodbury on ``(I + C_i J_j)^{-1}`` with
``G = U_iᵀ Z_j``):
  (I + C_i J_j)^{-1}      = I - U_i (I + GGᵀ)^{-1} G Z_jᵀ
  (I + C_i J_j)^{-1} C_i  = U_i (I + GGᵀ)^{-1} U_iᵀ
  (I + J_j C_i)^{-1} J_j  = Z_j (I + GᵀG)^{-1} Z_jᵀ
so each combine costs two ``[nx, 2nx]`` QRs and triangular solves and
never forms C or J. Every function broadcasts over leading axes, so the
batched drivers build all ``B x n`` elements at once and scan them with
`repro_torch.core.scan.associative_scan` (``batch_dims=1``). The JAX
package's square-root form reaches no Pallas kernel; its combines here are
plain PyTorch (``torch.linalg.qr``, ``solve_triangular``). Factors are
unique only up to orthogonal right-multiplication (QR sign conventions
differ between libraries): compare ``U Uᵀ``, ``Z Zᵀ``, ``D Dᵀ`` and the
means, never the factors.

``axis_name`` shards the time axis as in `repro_torch.core.parallel`,
with the same repair of the reference's shard boundaries (ROADMAP C7):
the prior's element only at axis index 0, the next shard's first
transition in a shard's last smoothing element, and row 0 of the
smoother's ``n_local + 1`` rows the previous shard's last smoothed state
on every shard but the first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import scan as scan_lib
from .parallel import _holds_first, _next_transition, _previous_smoothed
from .types import (Gaussian, LinearizedSSM, add_lane,
                    bcast_prior as _bcast_prior, cholesky, drop_lane, solve,
                    symmetrize)


class SqrtFilteringElement(NamedTuple):
    A: torch.Tensor    # [..., nx, nx]
    b: torch.Tensor    # [..., nx]
    U: torch.Tensor    # [..., nx, nx]  lower-tri factor of C
    eta: torch.Tensor  # [..., nx]
    Z: torch.Tensor    # [..., nx, nx]  factor of J


class SqrtSmoothingElement(NamedTuple):
    E: torch.Tensor  # [..., nx, nx]
    g: torch.Tensor  # [..., nx]
    D: torch.Tensor  # [..., nx, nx]  lower-tri factor of L


def _T(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse without the device synchronization of
    ``torch.linalg.inv``'s error check."""
    return torch.linalg.inv_ex(A)[0]


def _solve_lower(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, X, upper=False)


def _solve_lower_vec(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _solve_lower(L, x[..., None])[..., 0]


def _zeros(like: torch.Tensor, *shape: int) -> torch.Tensor:
    """Zeros ``[*like.shape[:-2], *shape]`` in ``like``'s dtype/device."""
    return like.new_zeros(tuple(like.shape[:-2]) + shape)


def tria(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular T with T Tᵀ = M Mᵀ, via QR of Mᵀ (M [..., n, m])."""
    return _T(torch.linalg.qr(_T(M), mode="r")[1])


def _chol_inv_apply(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)^{-1} X given lower-triangular L."""
    y = _solve_lower(L, X)
    return torch.linalg.solve_triangular(_T(L), y, upper=True)


# ---------------------------------------------------------------------------
# Element construction
# ---------------------------------------------------------------------------

def _sqrt_predict_update(F, c, LQ, H, d, LR, y, m, LP):
    """One square-root KF step from (m, chol P). Returns (m', LP')."""
    nx = m.shape[-1]
    ny = y.shape[-1]
    LP_pred = tria(torch.cat([F @ LP, LQ], dim=-1))
    m_pred = _mv(F, m) + c
    # Joint triangularization gives chol(S), the gain factor and chol(P').
    top = torch.cat([H @ LP_pred, LR], dim=-1)                   # [ny, .]
    bot = torch.cat([LP_pred, _zeros(LP, nx, ny)], dim=-1)
    Psi = tria(torch.cat([top, bot], dim=-2))
    Psi11 = Psi[..., :ny, :ny]
    Psi21 = Psi[..., ny:, :ny]
    Psi22 = Psi[..., ny:, ny:]
    innov = y - (_mv(H, m_pred) + d)
    m_new = m_pred + _mv(Psi21, _solve_lower_vec(Psi11, innov))
    return m_new, Psi22


def _first_sqrt_element(F, c, LQ, H, d, LR, y1, m0, LP0
                        ) -> SqrtFilteringElement:
    b, U = _sqrt_predict_update(F, c, LQ, H, d, LR, y1, m0, LP0)
    return SqrtFilteringElement(A=torch.zeros_like(U), b=b, U=U,
                                eta=torch.zeros_like(b),
                                Z=torch.zeros_like(U))


def _generic_sqrt_element(F, c, LQ, H, d, LR, y) -> SqrtFilteringElement:
    nx = F.shape[-1]
    ny = y.shape[-1]
    I = torch.eye(nx, dtype=F.dtype, device=F.device)
    top = torch.cat([H @ LQ, LR], dim=-1)
    bot = torch.cat([LQ, _zeros(F, nx, ny)], dim=-1)
    Psi = tria(torch.cat([top, bot], dim=-2))
    Psi11 = Psi[..., :ny, :ny]     # chol(S)
    Psi21 = Psi[..., ny:, :ny]     # Q' Hᵀ chol(S)^{-T}
    U = Psi[..., ny:, ny:]         # chol((I - K H) Q')
    K = Psi21 @ _inv(Psi11)        # small ny; triangular inverse
    innov = y - (_mv(H, c) + d)
    A = (I - K @ H) @ F
    b = c + _mv(K, innov)
    # Z Zᵀ = (H F)ᵀ S^{-1} (H F):  Z = Fᵀ Hᵀ chol(S)^{-T} — naturally
    # [nx, ny]; normalized to a square [nx, nx] factor (zero-padded or
    # re-triangularized) so scan elements are shape-uniform.
    Z = _T(_solve_lower(Psi11, H @ F))
    eta = _mv(Z, _solve_lower_vec(Psi11, innov))
    if ny < nx:
        Z = torch.cat([Z, _zeros(F, nx, nx - ny)], dim=-1)
    elif ny > nx:
        Z = tria(Z)
    return SqrtFilteringElement(A=A, b=b, U=U, eta=eta, Z=Z)


def sqrt_filtering_elements_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                    m0: torch.Tensor, P0: torch.Tensor
                                    ) -> SqrtFilteringElement:
    """All ``B x n`` square-root filtering elements in one batched
    computation; the k=1 case is written into row 0 of every lane."""
    return _sqrt_filtering_elements_batched(lin, ys, m0, P0, first=True)


def _sqrt_filtering_elements_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                     m0: torch.Tensor, P0: torch.Tensor, *,
                                     first: bool) -> SqrtFilteringElement:
    """`sqrt_filtering_elements_batched`; ``first=False`` keeps the
    generic element in row 0 (a shard that does not hold k=1)."""
    B = ys.shape[0]
    LQ = cholesky(symmetrize(lin.Qp))
    LR = cholesky(symmetrize(lin.Rp))
    generic = _generic_sqrt_element(lin.F, lin.c, LQ, lin.H, lin.d, LR, ys)
    if not first:
        return generic
    LP0 = cholesky(symmetrize(_bcast_prior(P0, B, 2)))
    k1 = _first_sqrt_element(
        lin.F[:, 0], lin.c[:, 0], LQ[:, 0], lin.H[:, 0], lin.d[:, 0],
        LR[:, 0], ys[:, 0], _bcast_prior(m0, B, 1), LP0)
    return SqrtFilteringElement(*(torch.cat([f[:, None], g[:, 1:]], dim=1)
                                  for f, g in zip(k1, generic)))


# ---------------------------------------------------------------------------
# Combines
# ---------------------------------------------------------------------------

def sqrt_filtering_combine(ei: SqrtFilteringElement,
                           ej: SqrtFilteringElement
                           ) -> SqrtFilteringElement:
    """Eq. 15 on factors: ``a_i (x) a_j`` with ``i`` earlier than ``j``."""
    nx = ei.b.shape[-1]
    G = _T(ei.U) @ ej.Z                                  # U_iᵀ Z_j
    I = torch.eye(nx, dtype=G.dtype, device=G.device).expand(G.shape)
    L1 = tria(torch.cat([G, I], dim=-1))                 # chol(I + GGᵀ)
    L2 = tria(torch.cat([_T(G), I], dim=-1))

    # T1 = (I + C_i J_j)^{-1}
    T1 = I - ei.U @ _chol_inv_apply(L1, G @ _T(ej.Z))
    AjT1 = ej.A @ T1
    A = AjT1 @ ei.A
    b = _mv(AjT1, ei.b + _mv(ei.U, _mv(_T(ei.U), ej.eta))) + ej.b
    # C part: A_j U_i (I + GGᵀ)^{-1} U_iᵀ A_jᵀ + C_j
    U1 = ej.A @ ei.U @ _T(_inv(L1))                      # A_j U_i L1^{-T}
    U = tria(torch.cat([U1, ej.U], dim=-1))
    # eta / J part
    T1t = _T(T1)                                         # (I + J_j C_i)^{-1}
    eta = _mv(_T(ei.A), _mv(T1t, ej.eta - _mv(ej.Z, _mv(_T(ej.Z), ei.b)))) \
        + ei.eta
    Z1 = _T(ei.A) @ ej.Z @ _T(_inv(L2))                  # A_iᵀ Z_j L2^{-T}
    Z = tria(torch.cat([Z1, ei.Z], dim=-1))
    return SqrtFilteringElement(A=A, b=b, U=U, eta=eta, Z=Z)


def sqrt_smoothing_combine(ei: SqrtSmoothingElement,
                           ej: SqrtSmoothingElement) -> SqrtSmoothingElement:
    """Eq. 19 on factors: ``a_i (x) a_j`` with ``i`` earlier than ``j``."""
    E = ei.E @ ej.E
    g = _mv(ei.E, ej.g) + ei.g
    D = tria(torch.cat([ei.E @ ej.D, ei.D], dim=-1))
    return SqrtSmoothingElement(E=E, g=g, D=D)


def sqrt_filtering_identity(nx: int, dtype=torch.float32, device=None
                            ) -> SqrtFilteringElement:
    kw = dict(dtype=dtype, device=device)
    return SqrtFilteringElement(
        A=torch.eye(nx, **kw), b=torch.zeros((nx,), **kw),
        U=torch.zeros((nx, nx), **kw), eta=torch.zeros((nx,), **kw),
        Z=torch.zeros((nx, nx), **kw))


def sqrt_smoothing_identity(nx: int, dtype=torch.float32, device=None
                            ) -> SqrtSmoothingElement:
    kw = dict(dtype=dtype, device=device)
    return SqrtSmoothingElement(E=torch.eye(nx, **kw),
                                g=torch.zeros((nx,), **kw),
                                D=torch.zeros((nx, nx), **kw))


# ---------------------------------------------------------------------------
# Batched drivers (batch axis before time; one combine call per level)
# ---------------------------------------------------------------------------

def sqrt_parallel_filter_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                 m0: torch.Tensor, P0: torch.Tensor, *,
                                 axis_name: Optional[str] = None
                                 ) -> Gaussian:
    """Batched square-root parallel filter over ``[B, n]`` trajectories:
    filtered ``[B, n, ...]`` with covariances ``U Uᵀ``; with
    ``axis_name``, of this rank's time shard (module docstring)."""
    elems = _sqrt_filtering_elements_batched(lin, ys, m0, P0,
                                             first=_holds_first(axis_name))
    scanned = scan_lib.associative_scan(
        sqrt_filtering_combine, elems, reverse=False, axis_name=axis_name,
        batch_dims=1,
        identity=lambda: sqrt_filtering_identity(
            lin.F.shape[-1], lin.F.dtype, lin.F.device))
    return Gaussian(mean=scanned.b, cov=scanned.U @ _T(scanned.U))


def _generic_sqrt_smoothing_element(mf, Pf, F, c, LQk
                                    ) -> SqrtSmoothingElement:
    nx = mf.shape[-1]
    Uf = cholesky(symmetrize(Pf))
    top = torch.cat([F @ Uf, LQk], dim=-1)
    bot = torch.cat([Uf, _zeros(Uf, nx, nx)], dim=-1)
    Phi = tria(torch.cat([top, bot], dim=-2))
    Phi11 = Phi[..., :nx, :nx]
    Phi21 = Phi[..., nx:, :nx]
    D = Phi[..., nx:, nx:]
    E = Phi21 @ _inv(Phi11)
    g = mf - _mv(E, _mv(F, mf) + c)
    return SqrtSmoothingElement(E=E, g=g, D=D)


def sqrt_smoothing_elements_batched(lin: LinearizedSSM, filtered: Gaussian
                                    ) -> SqrtSmoothingElement:
    """Batched square-root smoothing elements over all ``B*(n-1)`` rows,
    with the k=n boundary element in the last row. Element k (row k-1)
    uses the transition k -> k+1, i.e. ``F[k]``."""
    return _sqrt_smoothing_elements_batched(lin, filtered, None)


def _sqrt_smoothing_elements_batched(lin: LinearizedSSM, filtered: Gaussian,
                                     nxt: Optional[tuple]
                                     ) -> SqrtSmoothingElement:
    """`sqrt_smoothing_elements_batched`; with ``nxt``, the transition
    ``(F, c, Qp)`` out of the last row, every row is a generic element."""
    if nxt is not None:
        F, c, Qp = (torch.cat([x[:, 1:], x_next[:, None]], dim=1)
                    for x, x_next in zip((lin.F, lin.c, lin.Qp), nxt))
        return _generic_sqrt_smoothing_element(
            filtered.mean, filtered.cov, F, c, cholesky(symmetrize(Qp)))
    LQ = cholesky(symmetrize(lin.Qp))
    body = _generic_sqrt_smoothing_element(
        filtered.mean[:, :-1], filtered.cov[:, :-1],
        lin.F[:, 1:], lin.c[:, 1:], LQ[:, 1:])
    last_cov = filtered.cov[:, -1]
    last = SqrtSmoothingElement(
        E=torch.zeros_like(last_cov), g=filtered.mean[:, -1],
        D=cholesky(symmetrize(last_cov)))
    return SqrtSmoothingElement(*(torch.cat([b, l[:, None]], dim=1)
                                  for b, l in zip(body, last)))


def sqrt_parallel_smoother_batched(lin: LinearizedSSM, filtered: Gaussian,
                                   m0: torch.Tensor, P0: torch.Tensor, *,
                                   axis_name: Optional[str] = None
                                   ) -> Gaussian:
    """Batched square-root parallel RTS smoother: smoothed ``[B, n+1,
    ...]``; the x_0 row is one extra backward step per lane through the
    first transition."""
    B = filtered.mean.shape[0]
    elems = _sqrt_smoothing_elements_batched(
        lin, filtered, _next_transition(lin, axis_name))
    scanned = scan_lib.associative_scan(
        sqrt_smoothing_combine, elems, reverse=True, axis_name=axis_name,
        batch_dims=1,
        identity=lambda: sqrt_smoothing_identity(
            lin.F.shape[-1], lin.F.dtype, lin.F.device))
    means = scanned.g
    covs = scanned.D @ _T(scanned.D)
    if axis_name is not None:
        prev = _previous_smoothed(means, covs, axis_name)
        if prev is not None:
            return Gaussian(mean=torch.cat([prev[0][:, None], means], dim=1),
                            cov=torch.cat([prev[1][:, None], covs], dim=1))

    F, c, Qp = lin.F[:, 0], lin.c[:, 0], lin.Qp[:, 0]
    m0b = _bcast_prior(m0, B, 1)
    P0b = _bcast_prior(P0, B, 2)
    P_pred = symmetrize(F @ P0b @ _T(F) + Qp)
    G = _T(solve(P_pred, F @ P0b))
    m0_s = m0b + _mv(G, means[:, 0] - (_mv(F, m0b) + c))
    P0_s = symmetrize(P0b + G @ (covs[:, 0] - P_pred) @ _T(G))
    return Gaussian(mean=torch.cat([m0_s[:, None], means], dim=1),
                    cov=torch.cat([P0_s[:, None], covs], dim=1))


def _sqrt_parallel_filter_smoother_batched(lin: LinearizedSSM,
                                           ys: torch.Tensor,
                                           m0: torch.Tensor, P0: torch.Tensor
                                           ) -> Tuple[Gaussian, Gaussian]:
    filtered = sqrt_parallel_filter_batched(lin, ys, m0, P0)
    smoothed = sqrt_parallel_smoother_batched(lin, filtered, m0, P0)
    return filtered, smoothed


def sqrt_parallel_filter_smoother_batched(lin: LinearizedSSM,
                                          ys: torch.Tensor, m0: torch.Tensor,
                                          P0: torch.Tensor
                                          ) -> Tuple[Gaussian, Gaussian]:
    """Deprecated: `build_smoother(spec).smooth` dispatches single vs
    batched from ``ys.ndim``. Runs on ``ys.device``."""
    from ._deprecation import warn_deprecated
    from .api import build_smoother
    warn_deprecated(
        "sqrt_parallel_filter_smoother_batched",
        'build_smoother(form="sqrt").smooth(lin, ys, m0, P0)')
    return build_smoother(form="sqrt", device=ys.device).smooth(
        lin, ys, m0, P0)


# ---------------------------------------------------------------------------
# Single-trajectory drivers: the batched ones on one lane
# ---------------------------------------------------------------------------

def sqrt_parallel_filter(lin: LinearizedSSM, ys, m0, P0, *,
                         axis_name=None) -> Gaussian:
    """Square-root parallel filter of one trajectory: filtered ``[n,
    ...]`` with covariances ``U Uᵀ``."""
    return drop_lane(sqrt_parallel_filter_batched(
        add_lane(lin), ys[None], m0, P0, axis_name=axis_name))


def sqrt_parallel_smoother(lin: LinearizedSSM, filtered: Gaussian, m0, P0,
                           *, axis_name=None) -> Gaussian:
    """Square-root parallel RTS smoother of one trajectory: smoothed
    ``[n+1, ...]``."""
    return drop_lane(sqrt_parallel_smoother_batched(
        add_lane(lin), add_lane(filtered), m0, P0, axis_name=axis_name))


def sqrt_parallel_filter_smoother(lin: LinearizedSSM, ys, m0, P0
                                  ) -> Tuple[Gaussian, Gaussian]:
    """One square-root parallel filtering + smoothing pass of one
    trajectory."""
    filtered, smoothed = _sqrt_parallel_filter_smoother_batched(
        add_lane(lin), ys[None], m0, P0)
    return drop_lane(filtered), drop_lane(smoothed)
