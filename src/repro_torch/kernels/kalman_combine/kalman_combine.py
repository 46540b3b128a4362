"""Batched Kalman combines (paper Eq. 15 and Eq. 19): hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

The kernels (``src/repro_torch/csrc/kalman_combine.cu``) replace the Pallas
TPU kernels ``filtering_combine_batched`` / ``smoothing_combine_batched``
of ``repro/kernels/kalman_combine/kalman_combine.py``. One Blelloch level
of the parallel smoother applies the combine to ``B x P`` element pairs;
written as tensor ops the filtering combine is ~15 separate batched ops,
each round-tripping ``[B, nx, nx]`` arrays through device memory, while
the kernel reads each pair once, keeps the nx x nx algebra on-chip and
writes the result once (see the source note in the ``.cu`` file).

``filtering_combine_math`` / ``smoothing_combine_math`` are the plain
versions of the same algebra (one shared Gauss-Jordan inverse for all four
solve sites of Eq. 15), broadcasting over any leading batch shape. They
serve the CPU, ``backend="jnp"``, and the on-card reference.

``filtering_combine_cuda`` / ``smoothing_combine_cuda`` are the kernel
wrappers over one flat leading batch axis. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises — never a fallback.
Each launch adds one to the kernel's entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.types import (FilteringElement, SmoothingElement,
                                    bmm as _bmm, bmv as _bmv,
                                    gauss_jordan_inverse as _gauss_jordan_inverse)

#: Kernel launches per kernel since the last `reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"filtering_combine": 0, "smoothing_combine": 0}

MAX_NX = 16
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

#: ``nvcc`` parts of ``csrc/kalman_combine.cu``, compiled at the same time:
#: the unrolled instances (nx <= 8) by cost, the rolled ones in two
#: groups, and the C entry points on their own.
BUILD_PARTS = tuple(
    (f"-DKC_NX_FIRST={a}", f"-DKC_NX_LAST={b}")
    for a, b in ((1, 4), (5, 5), (6, 6), (7, 7), (8, 8), (9, 12), (13, 16))
) + (("-DKC_NX_FIRST=0", "-DKC_NX_LAST=0", "-DKC_ENTRY_POINTS"),)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bt(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def filtering_combine_math(ai, bi, ci, ei, ji, aj, bj, cj, ej, jj):
    """Eq. 15 on batched tensors ``[..., nx(, nx)]``: what the kernel
    computes, as plain tensor ops (no per-matrix library solve)."""
    n = ai.shape[-1]
    eye = torch.eye(n, dtype=ai.dtype, device=ai.device)
    # W = (I + C_i J_j)^T = I + J_j C_i ; one inverse serves all solves.
    W = eye + _bmm(jj, ci)
    Winv = _gauss_jordan_inverse(W)
    X = _bmm(aj, _bt(Winv))                      # A_j (I + C_i J_j)^{-1}

    A = _bmm(X, ai)
    b = _bmv(X, bi + _bmv(ci, ej)) + bj
    Cnew = _bmm(_bmm(X, ci), _bt(aj)) + cj
    C = 0.5 * (Cnew + _bt(Cnew))
    z = _bmv(Winv, ej - _bmv(jj, bi))            # (I + J_j C_i)^{-1} (...)
    eta = _bmv(_bt(ai), z) + ei
    ZJ = _bmm(Winv, _bmm(jj, ai))
    Jnew = _bmm(_bt(ai), ZJ) + ji
    J = 0.5 * (Jnew + _bt(Jnew))
    return A, b, C, eta, J


def smoothing_combine_math(ei, gi, li, ej, gj, lj):
    """Eq. 19 on batched tensors (what the kernel computes)."""
    E = _bmm(ei, ej)
    g = _bmv(ei, gj) + gi
    Lnew = _bmm(_bmm(ei, lj), _bt(ei)) + li
    L = 0.5 * (Lnew + _bt(Lnew))
    return E, g, L


def filtering_combine_plain(ei: FilteringElement, ej: FilteringElement
                            ) -> FilteringElement:
    return FilteringElement(*filtering_combine_math(*ei, *ej))


def smoothing_combine_plain(ei: SmoothingElement, ej: SmoothingElement
                            ) -> SmoothingElement:
    return SmoothingElement(*smoothing_combine_math(*ei, *ej))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _library():
    """Build (first call) and bind the kernels' C interface."""
    from repro_torch.kernels.build import build

    built = build("kalman_combine", BUILD_PARTS)
    lib = built.lib
    if not getattr(lib, "_kc_bound", False):
        ptr = ctypes.c_void_p
        lib.kc_filtering_combine.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ptr] * 16)
        lib.kc_filtering_combine.restype = ctypes.c_int
        lib.kc_smoothing_combine.argtypes = (
            [ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ptr] * 10)
        lib.kc_smoothing_combine.restype = ctypes.c_int
        lib._kc_bound = True
    return lib


def _check(fields, B: int, nx: int, name: str) -> None:
    """Validate one side's tensors before their pointers reach C."""
    dtype, device = fields[0].dtype, fields[0].device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"{name}: nx={nx} outside 1..{MAX_NX}")
    for t in fields:
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name}: mixed dtype/device among fields")
        want = (B, nx) if t.ndim == 2 else (B, nx, nx)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: field shape {tuple(t.shape)}, "
                             f"expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input; the kernel "
                             "reads densely packed [B, ...] rows")


def _launch(fn, fields, outs, B: int, nx: int, name: str) -> None:
    args = [_DTYPE_CODE[fields[0].dtype], nx, B]
    args += [ctypes.c_void_p(t.data_ptr()) for t in fields + outs]
    args.append(ctypes.c_void_p(torch.cuda.current_stream(
        fields[0].device).cuda_stream))
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def filtering_combine_cuda(ei: FilteringElement, ej: FilteringElement
                           ) -> FilteringElement:
    """Eq. 15 over ``B`` flat element pairs (fields ``[B, nx(, nx)]``).

    CPU tensors take `filtering_combine_math`; CUDA tensors launch the
    hand-written kernel (nothing for ``B = 0``) or raise."""
    if not ei.b.is_cuda:
        return filtering_combine_plain(ei, ej)
    B, nx = ei.b.shape
    fields = list(ei) + list(ej)
    _check(fields, B, nx, "filtering_combine")
    outs = [torch.empty_like(t) for t in ei]
    if B:
        _launch(_library().kc_filtering_combine, fields, outs, B, nx,
                "filtering_combine")
    return FilteringElement(*outs)


def smoothing_combine_cuda(ei: SmoothingElement, ej: SmoothingElement
                           ) -> SmoothingElement:
    """Eq. 19 over ``B`` flat element pairs (fields ``[B, nx(, nx)]``).

    CPU tensors take `smoothing_combine_math`; CUDA tensors launch the
    hand-written kernel (nothing for ``B = 0``) or raise."""
    if not ei.g.is_cuda:
        return smoothing_combine_plain(ei, ej)
    B, nx = ei.g.shape
    fields = list(ei) + list(ej)
    _check(fields, B, nx, "smoothing_combine")
    outs = [torch.empty_like(t) for t in ei]
    if B:
        _launch(_library().kc_smoothing_combine, fields, outs, B, nx,
                "smoothing_combine")
    return SmoothingElement(*outs)
