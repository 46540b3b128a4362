"""The work of one call of each hand-written kernel, from its shapes: the
operations it must do and the bytes it must move (each input read once,
each output written once), as ``(operations, bytes)``.

One formula per kernel, used three ways: by the kernel's wrapper and its
model call sites, which declare a call's work to the step count
(`repro_torch.counting`, `launch.cost`), so that the kernel and its plain
version count alike; by `launch.roofline.bound_ms`, the least time of a
call on the card; and by ``chip_smoke.py``'s bounds.
"""
from __future__ import annotations

import functools
from typing import Tuple

Work = Tuple[float, float]


def values_per_element(kind: str, nx: int) -> int:
    """Values of one element of the filtering (Eq. 15) or smoothing (Eq.
    19) combine at state dimension ``nx``."""
    return 3 * nx * nx + 2 * nx if kind == "filtering_combine" \
        else 2 * nx * nx + nx


def flops_per_pair(kind: str, nx: int) -> int:
    """Floating-point operations of one pair, counted from the kernel's
    loops (multiply-adds count 2)."""
    if kind == "filtering_combine":
        return 20 * nx ** 3 + 15 * nx ** 2 + 4 * nx
    return 6 * nx ** 3 + 5 * nx ** 2 + nx


def combine_work(kind: str, pairs: int, nx: int, itemsize: int) -> Work:
    """One combine launch over ``pairs`` pairs: two elements read and one
    written per pair."""
    return (flops_per_pair(kind, nx) * pairs,
            3 * values_per_element(kind, nx) * itemsize * pairs)


def ssm_scan_work(n: int, itemsize: int) -> Work:
    """The linear recurrence over ``n = B T D`` values: ``a`` and ``b``
    read, ``h`` written, one multiply-add each."""
    return 2 * n, 3 * n * itemsize


@functools.lru_cache(maxsize=256)
def attention_pairs(Tq: int, Tk: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the mask lets through, queries right-aligned to
    the keys (a causal ``window`` too); a row that sees no key averages
    all ``Tk`` keys."""
    if not causal:
        return Tq * Tk
    return sum(min(Tk, max(Tk - Tq + i + 1, 0), window or Tk) or Tk
               for i in range(Tq))


def flash_work(B: int, Hq: int, Hkv: int, Tq: int, Tk: int, Dh: int,
               causal: bool, itemsize: int, window: int = 0) -> Work:
    """One attention call: q, k, v read and o written once, 4 Dh
    operations per (query, key) pair (`attention_pairs`)."""
    pairs = attention_pairs(Tq, Tk, causal, window)
    return (4 * B * Hq * Dh * pairs,
            itemsize * (2 * B * Hq * Tq * Dh + 2 * B * Hkv * Tk * Dh))


def decode_work(B: int, Hq: int, Hkv: int, L: int, Dh: int,
                itemsize: int) -> Work:
    """One decode call of ``Hq`` query rows per sequence against ``L``
    cached keys: the k and v rows read once, q read and o written, 4 Dh
    operations per (query, key) pair."""
    return (4 * B * Hq * Dh * L,
            itemsize * (2 * B * Hkv * L * Dh + 2 * B * Hq * Dh))
