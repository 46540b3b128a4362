"""Bucketing helpers of the smoother service (the port's own copy).

The JAX package's ``launch/autobatch.py`` holds the streaming queue; the
one-shot service needs only its key and width quantization, copied here
value for value so bucket signatures agree across the two packages.
"""
from __future__ import annotations

from typing import Tuple

Signature = Tuple[str, str, int, int]


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def pad_width(k: int, max_batch: int) -> int:
    """Batch padding width for ``k`` requests: next power of two, clamped
    to ``max_batch`` — O(log2 max_batch) launch widths per time bucket."""
    return min(next_pow2(max(k, 1)), max_batch)


def bucket_signature(model_id: str, method: str, n: int, nx: int
                     ) -> Signature:
    """The bucket key: ``(model_id, method, next_pow2(n), nx)``."""
    return (str(model_id), str(method), next_pow2(n), int(nx))


def spec_signature(spec, n: int, nx: int) -> Signature:
    """Bucket key for a `SmootherSpec`-built server: the tenant slot
    carries ``spec.spec_id``, so any change of any spec axis re-keys the
    bucket space."""
    return bucket_signature(spec.spec_id, spec.method, n, nx)
