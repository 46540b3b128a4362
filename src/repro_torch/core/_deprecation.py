"""Warn-once bookkeeping for the legacy smoother entry points.

The pre-`SmootherSpec` surface (``ieks``/``ipls`` and the ``*_batched``
driver twins) survives as thin delegating shims so downstream code keeps
working, but each shim announces its replacement exactly once per
process — a request fleet hitting a deprecated driver thousands of times
must not spam thousands of warnings. Kept dependency-free so every core
module (and `repro_torch.core.api` itself) can import it without cycles.
"""
from __future__ import annotations

import warnings
from typing import Set

_WARNED: Set[str] = set()


def warn_deprecated(name: str, replacement: str) -> None:
    """Emit one DeprecationWarning per process for ``name``.

    ``replacement`` is the `repro_torch.core.api` spelling the caller
    should migrate to (mentioning ``build_smoother``).
    """
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.{name} is deprecated; use {replacement} "
        f"(see repro_torch.core.build_smoother / SmootherSpec). This "
        f"warning fires once per process.",
        DeprecationWarning, stacklevel=3)


def reset_for_tests() -> None:
    """Clear the warned set (test isolation only)."""
    _WARNED.clear()
