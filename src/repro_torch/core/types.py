"""Core tensor types for the parallel iterated Kalman smoothers (PyTorch).

Same conventions as the JAX package's ``repro.core.types``:
  * ``n`` measurements ``y_{1:n}``; states ``x_{0:n}``.
  * Transition params ``F_k, c_k, Lambda_k`` map ``x_k -> x_{k+1}`` and are
    stored for ``k = 0..n-1`` (leading dim ``n``).
  * Measurement params ``H_k, d_k, Omega_k`` are for ``y_k`` at ``x_k``,
    ``k = 1..n``, stored 0-based (leading dim ``n``).
  * Filtering outputs have leading dim ``n`` (posteriors of ``x_1..x_n``).
  * Smoothing outputs have leading dim ``n+1`` (``x_0..x_n``).

Every batched tensor carries its batch axes in front (``[B, n, ...]``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when the card is asked for (explicitly or by
    default) on a host without one — nothing falls back to the CPU
    silently; pass ``device="cpu"`` to run the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


class Gaussian(NamedTuple):
    """A (batched) Gaussian ``N(mean, cov)``."""

    mean: torch.Tensor  # [..., nx]
    cov: torch.Tensor   # [..., nx, nx]


class LinearizedSSM(NamedTuple):
    """Affine-Gaussian approximation of the model over a full trajectory.

    ``p(x_{k+1}|x_k) ~= N(F[k] x_k + c[k], Qp[k])`` for ``k = 0..n-1`` and
    ``p(y_k|x_k) ~= N(H[k-1] x_k + d[k-1], Rp[k-1])`` for ``k = 1..n``.
    """

    F: torch.Tensor   # [..., n, nx, nx]
    c: torch.Tensor   # [..., n, nx]
    Qp: torch.Tensor  # [..., n, nx, nx]
    H: torch.Tensor   # [..., n, ny, nx]
    d: torch.Tensor   # [..., n, ny]
    Rp: torch.Tensor  # [..., n, ny, ny]


class FilteringElement(NamedTuple):
    """Parallel filtering element ``a_k = (A, b, C, eta, J)`` (paper Eq. 13-14)."""

    A: torch.Tensor    # [..., nx, nx]
    b: torch.Tensor    # [..., nx]
    C: torch.Tensor    # [..., nx, nx]
    eta: torch.Tensor  # [..., nx]
    J: torch.Tensor    # [..., nx, nx]


class SmoothingElement(NamedTuple):
    """Parallel smoothing element ``a_k = (E, g, L)`` (paper Eq. 17-18)."""

    E: torch.Tensor  # [..., nx, nx]
    g: torch.Tensor  # [..., nx]
    L: torch.Tensor  # [..., nx, nx]


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Nonlinear additive-Gaussian state-space model (paper Eq. 4).

    ``x_k = f(x_{k-1}) + q``, ``q ~ N(0, Q)``;
    ``y_k = h(x_k) + r``,     ``r ~ N(0, R)``;
    ``x_0 ~ N(m0, P0)``.

    ``f``/``h`` act on a single (unbatched) state vector and must be
    traceable by ``torch.func`` (``jacfwd``/``vmap``). ``R`` may be a
    stacked ``[n, ny, ny]`` or per-lane ``[B, n, ny, ny]`` array (serving
    inflates it on padded steps).
    """

    f: Callable[[torch.Tensor], torch.Tensor]
    h: Callable[[torch.Tensor], torch.Tensor]
    Q: torch.Tensor
    R: torch.Tensor
    m0: torch.Tensor
    P0: torch.Tensor

    @property
    def nx(self) -> int:
        return self.m0.shape[-1]

    @property
    def ny(self) -> int:
        return self.R.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.m0.device


def broadcast_noise(M: torch.Tensor, n: int) -> torch.Tensor:
    """Broadcast a single covariance to a stacked ``[n, d, d]`` array."""
    if M.ndim == 2:
        return M.expand((n,) + tuple(M.shape))
    if M.shape[0] != n:
        raise ValueError(f"noise stack has length {M.shape[0]}, expected {n}")
    return M


def symmetrize(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def gauss_jordan_inverse(W: torch.Tensor) -> torch.Tensor:
    """Batched inverse of ``[..., n, n]`` via Gauss-Jordan, unrolled over n.

    No pivoting, in the JAX package's elimination order: callers must
    pass matrices that are safe without it (positive definite, or
    ``I + PSD @ PSD`` whose spectrum lies right of 1). Pure vectorized
    arithmetic over the whole batch — no per-matrix library call — and
    the same elimination the CUDA combine kernel runs per thread.
    """
    n = W.shape[-1]
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    aug = torch.cat([W, eye.expand(W.shape[:-2] + (n, n))], dim=-1)
    is_row = torch.arange(n, device=W.device)[:, None]
    for k in range(n):
        pivot_row = aug[..., k:k + 1, :] / aug[..., k:k + 1, k:k + 1]
        factors = aug[..., :, k:k + 1]
        eliminated = aug - factors * pivot_row
        aug = torch.where(is_row == k, pivot_row, eliminated)
    return aug[..., :, n:]


def bmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched tiny matmul ``[..., n, m] @ [..., m, p]`` as broadcast-mul-
    reduce over the last axis: ``C[i,k] = sum_j A[i,j] * B^T[k,j]``."""
    return torch.sum(A[..., :, None, :] * B.transpose(-1, -2)[..., None, :, :],
                     dim=-1)


def bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matvec ``[..., n, m] @ [..., m] -> [..., n]``."""
    return torch.sum(A * x[..., None, :], dim=-1)


def bcast_prior(x: torch.Tensor, B: int, ndim: int) -> torch.Tensor:
    """Broadcast a shared prior (``[nx]``/``[nx, nx]``, i.e. ``ndim``
    axes) to ``B`` lanes; per-lane priors pass through unchanged."""
    if x.ndim == ndim:
        return x.expand((B,) + tuple(x.shape))
    return x


def add_lane(tree):
    """A NamedTuple of tensors (or one tensor) with a batch axis of one
    lane in front: how every single-trajectory driver reaches its batched
    counterpart."""
    if isinstance(tree, torch.Tensor):
        return tree[None]
    return type(tree)(*(x[None] for x in tree))


def drop_lane(tree):
    """Inverse of `add_lane`: the only lane of a batched result."""
    if isinstance(tree, torch.Tensor):
        return tree[0]
    return type(tree)(*(x[0] for x in tree))


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor that never synchronizes with the device:
    a matrix that is not positive definite yields NaNs (as
    ``jnp.linalg.cholesky`` does) instead of raising."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, math.nan), L)


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` without the device synchronization of
    ``torch.linalg.solve``'s error check."""
    return torch.linalg.solve_ex(A, B)[0]


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor
               ) -> torch.Tensor:
    """Log-density of ``N(x; mean, cov)`` (used for data log-likelihood)."""
    d = x.shape[-1]
    chol = cholesky(cov)
    diff = x - mean
    z = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (quad + logdet + d * math.log(2.0 * math.pi))

