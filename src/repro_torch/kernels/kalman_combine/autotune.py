"""Measured backend chooser for ``SmootherSpec.backend="auto"``.

The CUDA combine kernel wins when one Blelloch level carries enough
element pairs to amortize its launch; below that, the plain PyTorch
version may win. So ``"auto"`` does not guess: it *times* both for the
call site's ``(B, T, nx)`` once and caches the winner in a
``spec_id``-keyed in-process table — the JAX package's autotuner, with
the same keys, choices and contract:

  * `decide` NEVER measures — it is a dict lookup with a default for an
    unmeasured site: the CUDA kernel on the card (the port runs plain
    PyTorch on a CUDA tensor only where the measurement chose it), the
    plain version (``"fused"``, the JAX package's default) on the CPU;
  * `autotune` measures (at build time or server warmup, so streaming
    traffic never pays for it) and fills the cache;
  * on a CPU device there is no compiled lowering, so nothing is timed
    and the choice is ``"fused"``;
  * repeated builds and warmups for the same ``(spec_id, B, T, nx)`` hit
    the cache and do not re-measure.

The key's platform slot uses the JAX package's names (``"gpu"`` for a
CUDA device, ``"cpu"``), so `cache_entries` keys agree between the two
packages on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import Device, FilteringElement

from . import kalman_combine as _k
from . import ops as _ops

#: Timing repetitions per candidate (one extra warm call precedes them).
_REPS = 3

#: choice -> the combine_impl the scan should run.
CHOICE_KERNEL = "pallas"
CHOICE_FUSED = "fused"

Key = Tuple[str, str, int, int, int]

_cache: Dict[Key, dict] = {}


def _platform(device: Device) -> str:
    return "gpu" if _ops.kernel_backend(device) == "gpu" else "cpu"


def cache_key(spec_id: str, B: int, T: int, nx: int,
              device: Device = None) -> Key:
    """One entry per (spec identity, launch shape, platform of
    ``device``; ``None`` is the default device, the card where there is
    one)."""
    return (str(spec_id), _platform(device), int(B), int(T), int(nx))


def lookup(spec_id: str, B: int, T: int, nx: int,
           device: Device = None) -> Optional[dict]:
    return _cache.get(cache_key(spec_id, B, T, nx, device))


def decide(spec_id: str, B: Optional[int], T: Optional[int],
           nx: Optional[int], device: Device = None) -> str:
    """The choice for ``backend="auto"``: the cached measured winner, else
    the kernel on a CUDA device and the plain version on the CPU. A pure
    lookup — never measures."""
    entry = (None if B is None or T is None or nx is None
             else lookup(spec_id, B, T, nx, device))
    if entry is not None:
        return entry["choice"]
    return CHOICE_KERNEL if _platform(device) == "gpu" else CHOICE_FUSED


def clear_cache() -> None:
    _cache.clear()


def cache_entries() -> Dict[str, dict]:
    """Readable snapshot (the service reports it in its stats):
    ``"spec_id@platform/B=../T=../nx=.." -> {choice, backend, kernel_us,
    fused_us}``."""
    return {
        f"{sid}@{plat}/B={B}/T={T}/nx={nx}": dict(entry)
        for (sid, plat, B, T, nx), entry in sorted(_cache.items())
    }


def _time_us(fn, ei, ej) -> float:
    """Microseconds per call: one warm call (it builds the kernel on its
    first use, so the build is never timed), then `_REPS` back-to-back
    calls between two CUDA events. The events span the host's dispatch
    as well as the device's work, as the JAX package's wall-clock
    timing does."""
    with torch.cuda.device(ei.b.device):
        fn(ei, ej)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(_REPS):
            fn(ei, ej)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / _REPS * 1e3


def _level_elements(rows: int, pairs: int, nx: int, dtype: torch.dtype,
                    device: torch.device) -> FilteringElement:
    """A representative top-level operand: ``[rows, pairs]`` random
    filtering elements (well-conditioned PSD C/J), drawn from the JAX
    package's numpy stream."""
    rng = np.random.default_rng(0)
    n = rows * pairs

    def as_t(a):
        return torch.as_tensor(a.reshape((rows, pairs) + a.shape[1:]),
                               dtype=dtype, device=device)

    def psd():
        a = rng.standard_normal((n, nx, nx))
        return as_t(a @ np.swapaxes(a, -1, -2) / nx + 0.1 * np.eye(nx))

    return FilteringElement(
        A=as_t(rng.standard_normal((n, nx, nx)) / np.sqrt(nx)),
        b=as_t(rng.standard_normal((n, nx))),
        C=psd(),
        eta=as_t(rng.standard_normal((n, nx))),
        J=psd())


def autotune(spec_id: str, B: int, T: int, nx: int,
             dtype: torch.dtype = torch.float32,
             device: Device = None) -> dict:
    """Measure kernel vs plain version for one launch shape on ``device``
    and cache the winner. Idempotent per key; returns the cache entry.

    The probe is the filtering combine at the scan's *top level*: a
    ``[B, T // 2]`` pair grid, the widest, most kernel-favourable level
    (if the kernel loses there it loses everywhere). Its dtype is the
    JAX package's default, f32, whatever the service's.
    """
    key = cache_key(spec_id, B, T, nx, device)
    if key in _cache:
        return _cache[key]
    backend = _ops.kernel_backend(device)
    if backend is None:
        entry = {"choice": CHOICE_FUSED, "backend": "none",
                 "kernel_us": None, "fused_us": None}
        _cache[key] = entry
        return entry
    dev = torch.device("cuda" if device is None else device)
    pairs = max(int(T) // 2, 1)
    ei = _level_elements(int(B), pairs, nx, dtype, dev)
    ej = _level_elements(int(B), pairs, nx, dtype, dev)
    kernel_us = _time_us(_k.filtering_combine_cuda, ei, ej)
    fused_us = _time_us(_k.filtering_combine_plain, ei, ej)
    choice = CHOICE_KERNEL if kernel_us < fused_us else CHOICE_FUSED
    entry = {"choice": choice, "backend": backend,
             "kernel_us": kernel_us, "fused_us": fused_us}
    _cache[key] = entry
    return entry
