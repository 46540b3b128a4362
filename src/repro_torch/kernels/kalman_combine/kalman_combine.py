"""Batched Kalman combines (paper Eq. 15 and Eq. 19): hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

The kernels (``src/repro_torch/csrc/kalman_combine.cu``) replace the Pallas
TPU kernels ``filtering_combine_batched`` / ``smoothing_combine_batched``
of ``repro/kernels/kalman_combine/kalman_combine.py``. One Blelloch level
of the parallel smoother applies the combine to ``L x P`` element pairs;
written as tensor ops the filtering combine is ~15 separate batched ops,
each round-tripping ``[L, P, nx, nx]`` arrays through device memory, while
the kernel reads each pair once, keeps the nx x nx algebra on-chip and
writes the result once (see the source note in the ``.cu`` file).

``filtering_combine_math`` / ``smoothing_combine_math`` are the plain
versions of the same algebra (one shared Gauss-Jordan inverse for all four
solve sites of Eq. 15), broadcasting over any leading batch shape. They
serve the CPU, ``backend="jnp"``, and the on-card reference.

``filtering_combine_cuda`` / ``smoothing_combine_cuda`` are the kernel
wrappers. Batching contract: each field is a view of ``[L, P]`` pairs
(``[L, P, nx(, nx)]``, or ``[P, ...]`` as one row) with any strides over
the pair grid and a dense trailing block, so a scan level's slices are
read in place, with no packing copy. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises — never a fallback.
Each launch adds one to the kernel's entry in ``LAUNCHES``; each call of
a plain version, one to its entry in ``PLAIN_CALLS``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.types import (FilteringElement, SmoothingElement,
                                    bmm as _bmm, bmv as _bmv,
                                    gauss_jordan_inverse as _gauss_jordan_inverse)
from repro_torch import counting
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.work import combine_work

#: Kernel launches per kernel since the last `reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"filtering_combine": 0, "smoothing_combine": 0}
#: Calls of the plain versions since the last `reset_launch_counts`.
PLAIN_CALLS: Dict[str, int] = {"filtering_combine": 0,
                               "smoothing_combine": 0}

MAX_NX = 16
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

#: ``nvcc`` parts of ``csrc/kalman_combine.cu``, compiled at the same time:
#: the instances grouped by nx, the large ones alone (a lane's unrolled
#: code grows as nx^2), and the C entry points on their own.
BUILD_PARTS = tuple(
    (f"-DKC_NX_FIRST={a}", f"-DKC_NX_LAST={b}")
    for a, b in ((1, 6), (7, 9), (10, 11), (12, 13), (14, 14), (15, 15),
                 (16, 16))
) + (("-DKC_NX_FIRST=0", "-DKC_NX_LAST=0", "-DKC_ENTRY_POINTS"),)
#: Trailing axes of each field of one element (2: matrix, 1: vector).
_FILTERING_BLOCKS = (2, 1, 2, 1, 2)
_SMOOTHING_BLOCKS = (2, 1, 2)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


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
    PLAIN_CALLS["filtering_combine"] += 1
    return FilteringElement(*filtering_combine_math(*ei, *ej))


def smoothing_combine_plain(ei: SmoothingElement, ej: SmoothingElement
                            ) -> SmoothingElement:
    PLAIN_CALLS["smoothing_combine"] += 1
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
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        strides = ctypes.POINTER(ctypes.c_longlong)
        for fn in (lib.kc_filtering_combine, lib.kc_smoothing_combine):
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ptrs, strides, strides, ptrs,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib._kc_bound = True
    return lib


def _check(fields, blocks: Sequence[int], name: str):
    """Validate one call's tensors before their pointers reach C; returns
    the pair grid (``(P,)`` or ``(L, P)``) and each field's lead and pair
    strides over it.

    ``blocks[f]`` is the number of trailing axes of field ``f`` (2 for a
    matrix, 1 for a vector). Each field is ``grid + (nx,) * blocks[f]``
    with any strides over the grid, but its trailing block must be dense
    (the kernels read each pair's block as ``nx`` or ``nx * nx``
    consecutive values)."""
    dtype, device = fields[0].dtype, fields[0].device
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    vec = fields[blocks.index(1)]
    grid, nx = tuple(vec.shape[:-1]), vec.shape[-1]
    if not 1 <= nx <= MAX_NX:
        raise ValueError(f"{name}: nx={nx} outside 1..{MAX_NX}")
    g = len(grid)
    if g not in (1, 2):
        raise ValueError(f"{name}: fields must be [P, ...] or [L, P, ...], "
                         f"got a {g}-axis pair grid")
    dense = {1: (1,), 2: (nx, 1)}
    empty = 0 in grid
    lead, pair = [], []
    for t, nb in zip(fields, blocks):
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name}: mixed dtype/device among fields")
        if t.shape != grid + (nx,) * nb:
            raise ValueError(f"{name}: field shape {tuple(t.shape)}, "
                             f"expected {grid + (nx,) * nb}")
        st = t.stride()
        if nx > 1 and not empty and st[g:] != dense[nb]:
            raise ValueError(f"{name}: non-dense trailing block (strides "
                             f"{st}); the kernel reads each pair's "
                             f"{'x'.join([str(nx)] * nb)} block as "
                             "consecutive values")
        lead.append(st[0] if g == 2 else 0)
        pair.append(st[g - 1])
    return grid, lead, pair


def _launch(fn, fields, outs, grid: Tuple[int, ...], lead, pair,
            stream) -> int:
    """Call one C entry point on an ``(L, P)`` or ``(P,)`` pair grid with
    the fields' strides from `_check`; returns its CUDA error code."""
    L, P = (1,) + grid if len(grid) == 1 else grid
    n = len(fields)
    return fn(_DTYPE_CODE[fields[0].dtype], fields[0].shape[-1], L, P,
              (ctypes.c_void_p * n)(*[t.data_ptr() for t in fields]),
              (ctypes.c_longlong * n)(*lead), (ctypes.c_longlong * n)(*pair),
              (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]),
              stream)


def _combine_cuda(fn_name: str, name: str, blocks, ei, ej):
    fields = list(ei) + list(ej)
    refuse_autograd(name, *fields)
    grid, lead, pair = _check(fields, blocks * 2, name)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in ei]
    if 0 not in grid:
        stream = torch.cuda.current_stream(fields[0].device).cuda_stream
        err = _launch(getattr(_library(), fn_name), fields, outs, grid, lead,
                      pair, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        LAUNCHES[name] += 1
    return type(ei)(*outs)


def _counted(kind: str, vec: torch.Tensor) -> counting.kernel_call:
    """The count region of one combine over the pairs of ``vec``'s
    leading dimensions (an element's ``[..., nx]`` vector field)."""
    nx = vec.shape[-1]
    return counting.kernel_call(kind, lambda: combine_work(
        kind, vec.numel() // max(nx, 1), nx, vec.element_size()))


def filtering_combine_cuda(ei: FilteringElement, ej: FilteringElement
                           ) -> FilteringElement:
    """Eq. 15 over a grid of element pairs: fields ``[L, P, nx(, nx)]``
    (or ``[P, nx(, nx)]``, one row), read in place through their strides
    — a scan level's slices need no packing copy.

    CPU tensors take `filtering_combine_math`; CUDA tensors launch the
    hand-written kernel once (nothing for an empty grid) or raise.
    Outputs are fresh contiguous tensors of the same shapes. Either
    counts as `kernels.work.combine_work` in a step count."""
    with _counted("filtering_combine", ei.b):
        if not ei.b.is_cuda:
            return filtering_combine_plain(ei, ej)
        return _combine_cuda("kc_filtering_combine", "filtering_combine",
                             _FILTERING_BLOCKS, ei, ej)


def smoothing_combine_cuda(ei: SmoothingElement, ej: SmoothingElement
                           ) -> SmoothingElement:
    """Eq. 19 over a grid of element pairs (fields as in
    `filtering_combine_cuda`).

    CPU tensors take `smoothing_combine_math`; CUDA tensors launch the
    hand-written kernel once (nothing for an empty grid) or raise."""
    with _counted("smoothing_combine", ei.g):
        if not ei.g.is_cuda:
            return smoothing_combine_plain(ei, ej)
        return _combine_cuda("kc_smoothing_combine", "smoothing_combine",
                             _SMOOTHING_BLOCKS, ei, ej)
