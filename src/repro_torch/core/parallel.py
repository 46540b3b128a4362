"""Parallel-in-time filtering and smoothing (the paper's contribution).

Filtering: elements ``a_k = (A, b, C, eta, J)`` (Eq. 13-14), associative
combine (Eq. 15). The k-th *prefix* under the combine is the filtering
posterior ``N(x_k; b, C)``.

Smoothing: elements ``a_k = (E, g, L)`` (Eq. 17-18), associative combine
(Eq. 19) applied as a *reverse* (suffix) scan; the k-th suffix is the
smoothing marginal ``N(x_k; g, L)``.

Both scans run through :func:`repro_torch.core.scan.associative_scan`
with ``batch_dims=1``: each Blelloch level is one combine call over all
``B x P`` element pairs of the fleet. The single-trajectory drivers
(``filtering_elements``, ``parallel_filter``, ...) are the batched ones
on one lane: on the card each of their scan levels is a ``[1, P]`` grid
of pairs for the kernels. The paper typos the JAX package
corrects (Eq. 13 ``b_k`` uses ``d_k``; Eq. 14 ``eta_k`` has no extra
``H``) are corrected here the same way.

``axis_name`` shards the time axis over that axis of the ambient mesh
(`repro_torch.distributed`): each rank passes its shard of ``lin`` and
``ys`` and the scans run as `sharded_associative_scan`. Unlike the
reference (ROADMAP C7), every shard's rows are the unsharded driver's:
the first filtering element is built from the prior only at axis index
0 and is the generic element elsewhere; a shard's last smoothing element
uses the next shard's first transition (one `ppermute` backwards) and is
the terminal element only on the last shard. The smoother keeps the
reference's shape contract of ``n_local + 1`` rows per shard: row 0 is
x_0 on the first shard and the previous shard's last smoothed state
elsewhere (one `ppermute` forwards), so dropping row 0 of every shard
but the first and concatenating gives the unsharded ``n + 1`` rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed import axis_index, axis_size, ppermute

from . import scan as scan_lib
from .types import (FilteringElement, Gaussian, LinearizedSSM,
                    SmoothingElement, add_lane, bcast_prior as _bcast_prior,
                    bmm as _mm, bmv as _mv, drop_lane, gauss_jordan_inverse,
                    solve, symmetrize)


def _T(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _mvm(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product through ``matmul`` (the textbook path)."""
    return (A @ x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Associative combines (textbook form, batched over any leading axes)
# ---------------------------------------------------------------------------

def filtering_combine(ei: FilteringElement, ej: FilteringElement
                      ) -> FilteringElement:
    """Paper Eq. 15: ``a_i (x) a_j`` with ``i`` earlier in time than ``j``.

    All four solves share the single matrix ``W = (I + C_i J_j)^T``, so
    one LU solve with a stacked right-hand side serves the whole combine.
    """
    nx = ei.b.shape[-1]
    I = torch.eye(nx, dtype=ei.b.dtype, device=ei.b.device)
    W = I + ej.J @ ei.C  # == (I + C_i J_j)^T
    rhs = torch.cat(
        [_T(ej.A),
         (ej.eta - _mvm(ej.J, ei.b))[..., None],
         ej.J @ ei.A],
        dim=-1)
    sol = solve(W, rhs)
    Xt = sol[..., :nx]                 # == X^T
    z_eta = sol[..., nx]
    Z_J = sol[..., nx + 1:]
    X = _T(Xt)

    A = X @ ei.A
    b = _mvm(X, ei.b + _mvm(ei.C, ej.eta)) + ej.b
    C = symmetrize(X @ ei.C @ _T(ej.A) + ej.C)
    eta = _mvm(_T(ei.A), z_eta) + ei.eta
    J = symmetrize(_T(ei.A) @ Z_J + ei.J)
    return FilteringElement(A=A, b=b, C=C, eta=eta, J=J)


def smoothing_combine(ei: SmoothingElement, ej: SmoothingElement
                      ) -> SmoothingElement:
    """Paper Eq. 19: ``a_i (x) a_j`` with ``i`` earlier in time than ``j``."""
    E = ei.E @ ej.E
    g = _mvm(ei.E, ej.g) + ei.g
    L = symmetrize(ei.E @ ej.L @ _T(ei.E) + ei.L)
    return SmoothingElement(E=E, g=g, L=L)


def filtering_identity(nx: int, dtype=torch.float32, device=None
                       ) -> FilteringElement:
    """Identity element of the filtering combine."""
    z = torch.zeros((nx, nx), dtype=dtype, device=device)
    v = torch.zeros((nx,), dtype=dtype, device=device)
    return FilteringElement(
        A=torch.eye(nx, dtype=dtype, device=device), b=v, C=z, eta=v, J=z)


def smoothing_identity(nx: int, dtype=torch.float32, device=None
                       ) -> SmoothingElement:
    return SmoothingElement(
        E=torch.eye(nx, dtype=dtype, device=device),
        g=torch.zeros((nx,), dtype=dtype, device=device),
        L=torch.zeros((nx, nx), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Element construction (batched: leading [B, n])
# ---------------------------------------------------------------------------

def _first_filtering_element(F, c, Qp, H, d, Rp, y1, m0, P0
                             ) -> FilteringElement:
    """k = 1 per lane: a predict+update collapsed into (A=0, b=m1|1,
    C=P1|1); eta/J are zero (nothing lies left of k=1)."""
    m_pred = _mvm(F, m0) + c
    P_pred = symmetrize(F @ P0 @ _T(F) + Qp)
    S = symmetrize(H @ P_pred @ _T(H) + Rp)
    K = _T(solve(S, H @ P_pred))
    b = m_pred + _mvm(K, y1 - (_mvm(H, m_pred) + d))
    C = symmetrize(P_pred - K @ S @ _T(K))
    z = torch.zeros_like(b)
    Z = torch.zeros_like(C)
    return FilteringElement(A=Z, b=b, C=C, eta=z, J=Z)


def _set_row(x: torch.Tensor, row: int, value: torch.Tensor) -> torch.Tensor:
    """``x`` with time row ``row`` of every lane replaced (out of place)."""
    out = x.clone()
    out[:, row] = value
    return out


def filtering_elements_batched(lin: LinearizedSSM, ys: torch.Tensor,
                               m0: torch.Tensor, P0: torch.Tensor
                               ) -> FilteringElement:
    """Build all ``B x n`` filtering elements as one contiguous block.

    ``lin`` leaves and ``ys`` carry a leading batch axis (``[B, n, ...]``);
    ``m0``/``P0`` may be shared (``[nx]``) or per-lane (``[B, nx]``). The
    generic rows (Eq. 13-14) are batched algebra over all ``B*n`` rows with
    one Gauss-Jordan inverse of S; the k=1 element is written in-batch
    into row 0 of every lane.
    """
    return _filtering_elements_batched(lin, ys, m0, P0, first=True)


def _filtering_elements_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                m0: torch.Tensor, P0: torch.Tensor, *,
                                first: bool) -> FilteringElement:
    """`filtering_elements_batched`; ``first=False`` (a shard that does
    not hold k=1) keeps the generic element in row 0."""
    B = ys.shape[0]
    F, c, Qp, H, d, Rp = lin
    nx = F.shape[-1]
    I = torch.eye(nx, dtype=F.dtype, device=F.device)
    S = symmetrize(_mm(_mm(H, Qp), _T(H)) + Rp)
    Sinv = gauss_jordan_inverse(S)               # S is PD: no-pivot safe
    K = _mm(_mm(Qp, _T(H)), Sinv)                # Q' H^T S^{-1}
    innov = ys - (_mv(H, c) + d)
    IKH = I - _mm(K, H)
    HF = _mm(H, F)
    generic = FilteringElement(
        A=_mm(IKH, F),
        b=c + _mv(K, innov),
        C=symmetrize(_mm(IKH, Qp)),
        eta=_mv(_T(HF), _mv(Sinv, innov)),
        J=symmetrize(_mm(_T(HF), _mm(Sinv, HF))))
    if not first:
        return generic
    k1 = _first_filtering_element(
        F[:, 0], c[:, 0], Qp[:, 0], H[:, 0], d[:, 0], Rp[:, 0], ys[:, 0],
        _bcast_prior(m0, B, 1), _bcast_prior(P0, B, 2))
    return FilteringElement(*(_set_row(g, 0, f)
                              for g, f in zip(generic, k1)))


def smoothing_elements_batched(lin: LinearizedSSM, filtered: Gaussian
                               ) -> SmoothingElement:
    """Batched Eq. 17-18 elements over all ``B*(n-1)`` rows (one
    Gauss-Jordan inverse of the PD ``P_pred``), with the k=n boundary
    element written in-batch into the last row. Element k (row k-1) uses
    the transition k -> k+1, i.e. ``F[k]``."""
    return _smoothing_elements_batched(lin, filtered, None)


def _smoothing_elements_batched(lin: LinearizedSSM, filtered: Gaussian,
                                nxt: Optional[tuple]) -> SmoothingElement:
    """`smoothing_elements_batched`; with ``nxt``, the transition ``(F, c,
    Qp)`` ``[B, ...]`` out of the last row (a shard followed by another),
    every row is a generic element and none the terminal one."""
    if nxt is not None:
        mf, Pf = filtered.mean, filtered.cov
        F, c, Qp = (torch.cat([x[:, 1:], x_next[:, None]], dim=1)
                    for x, x_next in zip((lin.F, lin.c, lin.Qp), nxt))
        return _generic_smoothing_elements(mf, Pf, F, c, Qp)
    B = filtered.mean.shape[0]
    nx = filtered.mean.shape[-1]
    body = _generic_smoothing_elements(
        filtered.mean[:, :-1], filtered.cov[:, :-1], lin.F[:, 1:],
        lin.c[:, 1:], lin.Qp[:, 1:])
    last = SmoothingElement(
        E=torch.zeros((B, nx, nx), dtype=filtered.mean.dtype,
                      device=filtered.mean.device),
        g=filtered.mean[:, -1], L=filtered.cov[:, -1])
    return SmoothingElement(*(torch.cat([b, l[:, None]], dim=1)
                              for b, l in zip(body, last)))


def _generic_smoothing_elements(mf, Pf, F, c, Qp) -> SmoothingElement:
    """Eq. 17-18 on ``[B, m]`` rows: filtered ``mf, Pf`` and the
    transition ``F, c, Qp`` out of each row."""
    FPf = _mm(F, Pf)
    P_pred = symmetrize(_mm(FPf, _T(F)) + Qp)
    E = _mm(_T(FPf), gauss_jordan_inverse(P_pred))  # P F^T P_pred^{-1}
    return SmoothingElement(
        E=E,
        g=mf - _mv(E, _mv(F, mf) + c),
        L=symmetrize(Pf - _mm(E, FPf)))


# ---------------------------------------------------------------------------
# Batched passes: B trajectories, one combine call per Blelloch level
# ---------------------------------------------------------------------------

def _holds_first(axis_name: Optional[str]) -> bool:
    """Whether this rank's shard holds time step 1 (always, unsharded)."""
    return axis_name is None or axis_index(axis_name) == 0


def _next_transition(lin: LinearizedSSM, axis_name: Optional[str]):
    """The transition ``(F, c, Qp)`` ``[B, ...]`` out of this shard's last
    row: the next shard's first, by one `ppermute` backwards along
    ``axis_name``. None unsharded and on the last shard (its last row is
    the terminal element)."""
    if axis_name is None:
        return None
    D = axis_size(axis_name)
    nxt = ppermute((lin.F[:, 0], lin.c[:, 0], lin.Qp[:, 0]), axis_name,
                   [(i, i - 1) for i in range(1, D)])
    return None if axis_index(axis_name) == D - 1 else nxt


def _previous_smoothed(means: torch.Tensor, covs: torch.Tensor,
                      axis_name: str):
    """The previous shard's last smoothed ``(mean, cov)`` ``[B, ...]``
    (one `ppermute` forwards along ``axis_name``); None on the first
    shard, which computes x_0 instead."""
    D = axis_size(axis_name)
    prev = ppermute((means[:, -1], covs[:, -1]), axis_name,
                    [(i, i + 1) for i in range(D - 1)])
    return None if axis_index(axis_name) == 0 else prev


def parallel_filter_batched(lin: LinearizedSSM, ys: torch.Tensor,
                            m0: torch.Tensor, P0: torch.Tensor, *,
                            combine_impl: str = "fused",
                            axis_name: Optional[str] = None) -> Gaussian:
    """Batched parallel Kalman filter over ``[B, n]`` trajectories: a
    prefix scan with ``batch_dims=1``; with ``axis_name``, of this rank's
    time shard (module docstring)."""
    elems = _filtering_elements_batched(lin, ys, m0, P0,
                                        first=_holds_first(axis_name))
    scanned = scan_lib.associative_scan(
        filtering_combine, elems, reverse=False, combine_impl=combine_impl,
        axis_name=axis_name, batch_dims=1,
        identity=lambda: filtering_identity(lin.F.shape[-1], lin.F.dtype,
                                            lin.F.device))
    return Gaussian(mean=scanned.b, cov=scanned.C)


def parallel_smoother_batched(lin: LinearizedSSM, filtered: Gaussian,
                              m0: torch.Tensor, P0: torch.Tensor, *,
                              combine_impl: str = "fused",
                              axis_name: Optional[str] = None) -> Gaussian:
    """Batched parallel RTS smoother (suffix scan with ``batch_dims=1``).

    Returns smoothed marginals ``[B, n+1, nx]``; the x_0 row is one extra
    backward step per lane through the first transition. With
    ``axis_name``, ``[B, n_local+1, nx]`` per shard (module docstring).
    """
    B = filtered.mean.shape[0]
    elems = _smoothing_elements_batched(lin, filtered,
                                        _next_transition(lin, axis_name))
    scanned = scan_lib.associative_scan(
        smoothing_combine, elems, reverse=True, combine_impl=combine_impl,
        axis_name=axis_name, batch_dims=1,
        identity=lambda: smoothing_identity(lin.F.shape[-1], lin.F.dtype,
                                            lin.F.device))
    means, covs = scanned.g, scanned.L
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
    m0_s = m0b + _mvm(G, means[:, 0] - (_mvm(F, m0b) + c))
    P0_s = symmetrize(P0b + G @ (covs[:, 0] - P_pred) @ _T(G))
    return Gaussian(mean=torch.cat([m0_s[:, None], means], dim=1),
                    cov=torch.cat([P0_s[:, None], covs], dim=1))


def _parallel_filter_smoother_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                      m0: torch.Tensor, P0: torch.Tensor,
                                      *, combine_impl: str = "fused",
                                      axis_name: Optional[str] = None
                                      ) -> Tuple[Gaussian, Gaussian]:
    filtered = parallel_filter_batched(lin, ys, m0, P0,
                                       combine_impl=combine_impl,
                                       axis_name=axis_name)
    smoothed = parallel_smoother_batched(lin, filtered, m0, P0,
                                         combine_impl=combine_impl,
                                         axis_name=axis_name)
    return filtered, smoothed


def parallel_filter_smoother_batched(lin: LinearizedSSM, ys: torch.Tensor,
                                     m0: torch.Tensor, P0: torch.Tensor,
                                     *, combine_impl: str = "fused",
                                     axis_name: Optional[str] = None
                                     ) -> Tuple[Gaussian, Gaussian]:
    """Deprecated: `build_smoother(spec).smooth` dispatches single vs
    batched from ``ys.ndim``. Runs on ``ys.device``."""
    from ._deprecation import warn_deprecated
    from .api import build_smoother
    warn_deprecated(
        "parallel_filter_smoother_batched",
        'build_smoother(mode="parallel").smooth(lin, ys, m0, P0)')
    if axis_name is not None:
        # The sharded path is not representable on the spec axes.
        return _parallel_filter_smoother_batched(
            lin, ys, m0, P0, combine_impl=combine_impl,
            axis_name=axis_name)
    return build_smoother(combine_impl=combine_impl, device=ys.device
                          ).smooth(lin, ys, m0, P0)


# ---------------------------------------------------------------------------
# Single-trajectory drivers: the batched ones on one lane
# ---------------------------------------------------------------------------

def filtering_elements(lin: LinearizedSSM, ys: torch.Tensor,
                       m0: torch.Tensor, P0: torch.Tensor
                       ) -> FilteringElement:
    """All n filtering elements of one trajectory (leading dim n)."""
    return drop_lane(filtering_elements_batched(add_lane(lin), ys[None],
                                                m0, P0))


def smoothing_elements(lin: LinearizedSSM, filtered: Gaussian
                       ) -> SmoothingElement:
    """All n smoothing elements of one trajectory from its filtering
    results (Eq. 17-18); element k (row k-1) uses ``F[k]``."""
    return drop_lane(smoothing_elements_batched(add_lane(lin),
                                                add_lane(filtered)))


def parallel_filter(lin: LinearizedSSM, ys: torch.Tensor, m0: torch.Tensor,
                    P0: torch.Tensor, *, combine_impl: str = "jnp",
                    axis_name: Optional[str] = None) -> Gaussian:
    """Parallel Kalman filter of one trajectory: a prefix scan of its
    filtering elements. Filtered posteriors ``[n, ...]``."""
    return drop_lane(parallel_filter_batched(
        add_lane(lin), ys[None], m0, P0, combine_impl=combine_impl,
        axis_name=axis_name))


def parallel_smoother(lin: LinearizedSSM, filtered: Gaussian,
                      m0: torch.Tensor, P0: torch.Tensor, *,
                      combine_impl: str = "jnp",
                      axis_name: Optional[str] = None) -> Gaussian:
    """Parallel RTS smoother of one trajectory: a suffix scan of its
    smoothing elements, then one backward step to x_0. Smoothed marginals
    ``[n+1, ...]``."""
    return drop_lane(parallel_smoother_batched(
        add_lane(lin), add_lane(filtered), m0, P0,
        combine_impl=combine_impl, axis_name=axis_name))


def parallel_filter_smoother(lin: LinearizedSSM, ys: torch.Tensor,
                             m0: torch.Tensor, P0: torch.Tensor, *,
                             combine_impl: str = "jnp",
                             axis_name: Optional[str] = None
                             ) -> Tuple[Gaussian, Gaussian]:
    """One parallel filtering + smoothing pass of one trajectory:
    ``(filtered [n, ...], smoothed [n+1, ...])``."""
    filtered, smoothed = _parallel_filter_smoother_batched(
        add_lane(lin), ys[None], m0, P0, combine_impl=combine_impl,
        axis_name=axis_name)
    return drop_lane(filtered), drop_lane(smoothed)
