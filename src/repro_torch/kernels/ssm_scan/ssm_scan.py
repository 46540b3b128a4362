"""Diagonal linear-recurrence scan ``h_t = a_t h_{t-1} + b_t``: a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

The kernel (``src/repro_torch/csrc/ssm_scan.cu``) replaces the Pallas TPU
kernel ``ssm_scan_batched`` of ``repro/kernels/ssm_scan/ssm_scan.py``: one
thread per ``(b, d)`` channel walks the time axis with the carry in a
register.

``ssm_scan_plain`` computes the same function with tensor ops, in the TPU
kernel's schedule: a Hillis-Steele doubling scan inside time chunks of
``CHUNK`` steps, all chunks at once, then the affine carry across chunks.
It serves CPU tensors and is the on-card reference.

``ssm_scan_cuda`` is the kernel wrapper over contiguous ``[B, T, D]``
tensors. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises — never a fallback. Each launch adds one to
``LAUNCHES["ssm_scan"]``.

float32 and float64 compute in their own type; bfloat16 is carried in
float32 and rounded to bfloat16 once per output, in both versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch import counting
from repro_torch.kernels import refuse_autograd
from repro_torch.kernels.work import ssm_scan_work

#: Kernel launches since the last `reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"ssm_scan": 0}

#: Time-chunk length of the plain version's doubling scan (the TPU
#: kernel's default ``CT``).
CHUNK = 128

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.bfloat16 else dtype


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def ssm_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All states of the recurrence for ``a, b [B, T, D]`` -> ``[B, T, D]``
    (initial state 0), as tensor ops: doubling inside chunks of ``CHUNK``
    steps, then the carry ``h = A_pref h_in + B_pref`` across chunks."""
    B, T, D = a.shape
    out_dtype = a.dtype
    if counting.shapes_only(a):
        return torch.empty_like(a)   # counted by the kernel's formula
    if B * T * D == 0:
        return a.new_empty((B, T, D))
    work = _compute_dtype(out_dtype)
    a, b = a.to(work), b.to(work)
    ct = min(CHUNK, T)
    pad = (-T) % ct
    if pad:  # identity elements (a=1, b=0) at the end change no state
        a = torch.cat([a, a.new_ones((B, pad, D))], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, D))], dim=1)
    nc = (T + pad) // ct
    A = a.reshape(B, nc, ct, D)
    Bp = b.reshape(B, nc, ct, D)
    s = 1
    while s < ct:
        Bp = torch.cat([Bp[:, :, :s], A[:, :, s:] * Bp[:, :, :-s]
                        + Bp[:, :, s:]], dim=2)
        A = torch.cat([A[:, :, :s], A[:, :, s:] * A[:, :, :-s]], dim=2)
        s *= 2
    outs = []
    carry = a.new_zeros((B, 1, D))
    for c in range(nc):
        outs.append(A[:, c] * carry + Bp[:, c])
        carry = outs[-1][:, -1:]
    out = torch.stack(outs, dim=1)  # no write in place: autograd runs it
    return out.reshape(B, nc * ct, D)[:, :T].to(out_dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def _library():
    """Build (first call) and bind the kernel's C interface."""
    from repro_torch.kernels.build import build

    lib = build("ssm_scan").lib
    if not getattr(lib, "_ss_bound", False):
        ll, ptr = ctypes.c_longlong, ctypes.c_void_p
        lib.ss_scan.argtypes = [ctypes.c_int, ll, ll, ll, ptr, ptr, ptr,
                                ptr]
        lib.ss_scan.restype = ctypes.c_int
        lib._ss_bound = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"ssm_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be [B, T, D]")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssm_scan: dtype {a.dtype} is not float32, "
                        "float64 or bfloat16")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError("ssm_scan: a and b differ in dtype or device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ssm_scan: non-contiguous input; the kernel reads "
                         "densely packed [B, T, D] arrays")


def ssm_scan_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All states for ``a, b [B, T, D]`` (initial state 0).

    CPU tensors take `ssm_scan_plain`; CUDA tensors launch the
    hand-written kernel (nothing when ``B T D = 0``) or raise. Either
    counts as `kernels.work.ssm_scan_work` in a step count."""
    _check(a, b)
    with counted_scan(a):
        return _ssm_scan(a, b)


def counted_scan(a: torch.Tensor) -> counting.kernel_call:
    """The count region of one scan of ``a, b [B, T, D]``
    (`kernels.work.ssm_scan_work`), which the wrapper and the model code
    that calls it or its plain version enter."""
    return counting.kernel_call("ssm_scan", lambda: ssm_scan_work(
        a.numel(), a.element_size()))


def _ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not a.is_cuda:
        return ssm_scan_plain(a, b)
    refuse_autograd("ssm_scan", a, b)
    B, T, D = a.shape
    h = torch.empty_like(a)
    if B * T * D == 0:
        return h
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _library().ss_scan(
        _DTYPE_CODE[a.dtype], B, T, D,
        *(ctypes.c_void_p(t.data_ptr()) for t in (a, b, h)),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    return h
