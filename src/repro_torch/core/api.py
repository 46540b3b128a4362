"""Unified estimator API: one declarative `SmootherSpec` + `build_smoother`.

`SmootherSpec` has the JAX package's fields, order, defaults and
validation, so :attr:`SmootherSpec.spec_id` is the same string in both
packages for equal fields — routes and autobatch signatures are shared.
`build_smoother(spec, device=...)` returns a `Smoother` bound to a device
(``cuda`` unless the caller names another; it raises on a host without a
card rather than falling back to the CPU). Its methods take batched
inputs ``ys [B, n, ny]`` or a single trajectory ``[n, ny]``, which runs
through the single-trajectory drivers (each the batched one on one lane).

Every axis value of the JAX package builds a working smoother:
``linearization`` taylor/slr (three sigma schemes), ``form``
standard/sqrt, ``damping`` fixed/adaptive, ``mode`` parallel/sequential.
``backend="tpu"`` raises when a smoother is built (no lowering here).

Quickstart::

    from repro_torch.core.api import SmootherSpec, build_smoother
    smoother = build_smoother(SmootherSpec(n_iter=10, tol=1e-6,
                                           lm_lambda=1.0))   # on cuda
    traj, info = smoother.iterate(model, ys, return_info=True)
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
from typing import Optional

import torch

from . import cost as _cost
from . import iterated as _iterated
from . import parallel as _parallel
from . import sequential as _sequential
from . import sqrt_parallel as _sqrt
from .iterated import (BACKENDS, COMBINE_IMPLS, DAMPINGS, FORMS,
                       IteratedConfig, validate_iteration_knobs)
from .sigma_points import SCHEMES
from .types import Device, Gaussian, LinearizedSSM, resolve_device

MODES = ("parallel", "sequential")
LINEARIZATIONS = ("taylor", "slr")

_SPEC_ID_VERSION = "v1"


def _check_choice(field: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {field} {value!r}; "
                         f"available: {sorted(allowed)}")


@dataclasses.dataclass(frozen=True)
class SmootherSpec:
    """Every axis of the smoother family, in one frozen declarative spec
    (the JAX package's axes: ``mode``, ``form``, ``linearization``,
    ``sigma_scheme``, iteration control ``n_iter``/``tol``/``lm_lambda``,
    ``combine_impl``, ``jitter``, ``model_id``, ``backend``,
    ``damping``). In the port ``backend="gpu"`` runs the CUDA combine
    kernels on the card, ``"jnp"`` their plain PyTorch versions,
    ``"auto"`` the winner :meth:`Smoother.autotune` measured for the
    launch shape (where nothing was measured: the kernels on the card,
    the plain versions on the CPU), and ``"tpu"`` raises when a smoother
    is built."""

    mode: str = "parallel"
    form: str = "standard"
    linearization: str = "taylor"
    sigma_scheme: str = "cubature"
    n_iter: int = 10
    tol: float = 0.0
    lm_lambda: float = 0.0
    combine_impl: str = "auto"
    jitter: float = 0.0
    model_id: str = ""
    backend: str = "auto"
    damping: str = "fixed"

    def __post_init__(self):
        _check_choice("mode", self.mode, MODES)
        _check_choice("form", self.form, FORMS)
        _check_choice("linearization", self.linearization, LINEARIZATIONS)
        _check_choice("sigma_scheme", self.sigma_scheme, SCHEMES)
        _check_choice("combine_impl", self.combine_impl, COMBINE_IMPLS)
        _check_choice("backend", self.backend, BACKENDS)
        _check_choice("damping", self.damping, DAMPINGS)
        if self.combine_impl == "pallas" and self.backend == "jnp":
            raise ValueError(
                'combine_impl="pallas" contradicts backend="jnp" '
                "(a compiled kernel with kernels disabled) — drop one")
        if self.form == "sqrt" and self.mode == "sequential":
            raise ValueError(
                'form="sqrt" requires mode="parallel": no sequential '
                "square-root pass is implemented")
        validate_iteration_knobs(self.n_iter, self.tol, self.lm_lambda,
                                 self.jitter)
        object.__setattr__(self, "_spec_id", self._compute_spec_id())

    @property
    def method(self) -> str:
        """Legacy linearization name ("ekf" | "slr") — the bucket
        signature's method slot and `IteratedConfig.method`."""
        return "ekf" if self.linearization == "taylor" else "slr"

    @property
    def spec_id(self) -> str:
        """Stable content hash of the full spec, equal to the JAX
        package's for equal fields (same payload, version and digest)."""
        return self._spec_id

    def _compute_spec_id(self) -> str:
        # The default damping ("fixed") stays out of the payload, as in
        # the JAX package, so ids from before that field existed hold.
        payload = ";".join(
            f"{f.name}={getattr(self, f.name)!r}"
            for f in dataclasses.fields(self)
            if not (f.name == "damping" and self.damping == "fixed"))
        digest = hashlib.sha1(
            f"{_SPEC_ID_VERSION};{payload}".encode()).hexdigest()[:12]
        prefix = self.model_id.split(":")[0] if self.model_id else "anon"
        return f"{prefix}/{digest}"

    @classmethod
    def from_iterated_config(cls, cfg: IteratedConfig,
                             **overrides) -> "SmootherSpec":
        """Lift a legacy `IteratedConfig` onto the spec axes (the bridge
        the deprecated shims use)."""
        kw = dict(
            mode="parallel" if cfg.parallel else "sequential",
            form=cfg.form,
            linearization="taylor" if cfg.method == "ekf" else "slr",
            sigma_scheme=cfg.sigma_scheme,
            n_iter=cfg.n_iter, tol=cfg.tol, lm_lambda=cfg.lm_lambda,
            combine_impl=cfg.combine_impl, jitter=cfg.jitter,
            model_id=cfg.model_id, damping=cfg.damping,
            backend=cfg.backend)
        kw.update(overrides)
        return cls(**kw)

    def iterated_config(self) -> IteratedConfig:
        """The execution `IteratedConfig` (``model_id`` = ``spec_id``)."""
        return IteratedConfig(
            method=self.method, n_iter=self.n_iter,
            parallel=self.mode == "parallel",
            sigma_scheme=self.sigma_scheme, lm_lambda=self.lm_lambda,
            combine_impl=self.combine_impl, jitter=self.jitter,
            tol=self.tol, model_id=self.spec_id, form=self.form,
            damping=self.damping, backend=self.backend)


class Smoother:
    """Configured estimator built by :func:`build_smoother`, bound to one
    device. ``ys [B, n, ny]`` runs the batched drivers, ``ys [n, ny]`` the
    single-trajectory ones (each the batched driver on one lane), so each
    (mode, form) cell has one code path. Calling the object is
    :meth:`iterate`."""

    __slots__ = ("spec", "config", "device")

    def __init__(self, spec: SmootherSpec, device: Device = None):
        self.spec = spec
        self.config = spec.iterated_config()
        self.config.check_backend()
        self.device = resolve_device(device)

    @property
    def spec_id(self) -> str:
        return self.spec.spec_id

    def __repr__(self) -> str:
        return f"Smoother({self.spec!r}, device={str(self.device)!r})"

    @staticmethod
    def _launch_shape(ys, m0):
        """``(B, T, nx)`` of a call site (``B = 1`` for a single
        trajectory, which runs as one lane) — the ``backend="auto"``
        autotune-cache key."""
        B = int(ys.shape[0]) if ys.ndim == 3 else 1
        return (B, int(ys.shape[-2]), int(m0.shape[-1]))

    # -- backend autotuning -------------------------------------------------

    def autotune(self, B: int, n: int, nx: int) -> dict:
        """Measure the CUDA combine kernel against its plain version for
        ``(B, n, nx)`` launches on this smoother's device, and cache the
        winner under its ``spec_id``.

        Idempotent per shape: `build_smoother` (``autotune_for``) and the
        server's warmup call it once per bucket shape. After it runs,
        ``backend="auto"`` call sites of the shape take the measured
        winner (unmeasured shapes run the kernels on the card); on the
        CPU nothing is measured and the choice is always ``"fused"``.
        Returns the cache entry ``{choice, backend,
        kernel_us, fused_us}``."""
        from repro_torch.kernels.kalman_combine import autotune as _at
        return _at.autotune(self.spec_id, B, n, nx, device=self.device)

    def _combine_impl(self, ys, m0) -> str:
        return self.config.resolved_combine_impl(
            True, shape=self._launch_shape(ys, m0), device=self.device)

    def _check_device(self, ys: torch.Tensor) -> None:
        if ys.device.type != self.device.type:
            raise ValueError(f"inputs are on {ys.device}, but this smoother "
                             f"runs on {self.device}")

    # -- one linearized pass ------------------------------------------------

    def filter(self, lin: LinearizedSSM, ys, m0, P0) -> Gaussian:
        """One filtering pass over an already-linearized SSM: filtered
        ``[n, ...]`` for ``ys [n, ny]``, ``[B, n, ...]`` for batched
        ``lin``/``ys``."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if self.spec.mode == "sequential":
            fn = (_sequential.kalman_filter_batched if batched
                  else _sequential.kalman_filter)
            return fn(lin, ys, m0, P0)
        if self.spec.form == "sqrt":
            fn = (_sqrt.sqrt_parallel_filter_batched if batched
                  else _sqrt.sqrt_parallel_filter)
            return fn(lin, ys, m0, P0)
        fn = (_parallel.parallel_filter_batched if batched
              else _parallel.parallel_filter)
        return fn(lin, ys, m0, P0, combine_impl=self._combine_impl(ys, m0))

    def smooth(self, lin: LinearizedSSM, ys, m0, P0):
        """One filtering + smoothing pass: ``(filtered, smoothed)``,
        smoothed with ``n + 1`` rows."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if self.spec.mode == "sequential":
            fn = (_sequential._filter_smoother_batched if batched
                  else _sequential.filter_smoother)
            return fn(lin, ys, m0, P0)
        if self.spec.form == "sqrt":
            fn = (_sqrt._sqrt_parallel_filter_smoother_batched if batched
                  else _sqrt.sqrt_parallel_filter_smoother)
            return fn(lin, ys, m0, P0)
        fn = (_parallel._parallel_filter_smoother_batched if batched
              else _parallel.parallel_filter_smoother)
        return fn(lin, ys, m0, P0, combine_impl=self._combine_impl(ys, m0))

    # -- the full iterated smoother ----------------------------------------

    def iterate(self, model, ys, init: Optional[Gaussian] = None,
                return_history: bool = False, return_info: bool = False):
        """Run up to ``n_iter`` linearize->filter->smooth passes
        (early-stopped under ``tol``, per-lane adaptive damping under
        ``damping="adaptive"``): ``[B, n + 1, ...]`` marginals (``[n + 1,
        ...]`` for ``ys [n, ny]``), then the mean history with
        ``return_history=True`` and the `LaneStatus` with
        ``return_info=True``."""
        self._check_device(ys)
        fn = (_iterated._iterated_smoother_batched if ys.ndim == 3
              else _iterated.iterated_smoother)
        return fn(model, ys, self.config, init=init,
                  return_history=return_history, return_info=return_info)

    __call__ = iterate

    def log_likelihood(self, model, ys, traj: Gaussian,
                       per_step: bool = False) -> torch.Tensor:
        """Measurement log-likelihood of ``ys`` under the smoothed
        posterior ``traj``: a scalar for one trajectory, ``[B]`` batched,
        the per-step terms with ``per_step=True``."""
        self._check_device(ys)
        return _iterated.smoothed_log_likelihood(
            model, ys, traj, self.config, per_step=per_step)

    def cost(self, model, ys, traj: Gaussian) -> torch.Tensor:
        """Gauss-Newton smoothing cost of ``traj`` (`core.cost.gn_cost`):
        a scalar for one trajectory, ``[B]`` batched."""
        self._check_device(ys)
        return _cost.gn_cost(model, ys, traj, method=self.spec.method,
                             scheme=self.spec.sigma_scheme,
                             jitter=self.spec.jitter)


def build_smoother(spec: Optional[SmootherSpec] = None, *,
                   device: Device = None,
                   autotune_for: Optional[tuple] = None,
                   **axes) -> Smoother:
    """Build the configured estimator for ``spec`` on ``device`` (default
    ``cuda``). Field overrides may be passed instead of, or on top of, a
    spec (``build_smoother(n_iter=5, device="cpu")``).

    ``autotune_for=(B, n, nx)`` runs :meth:`Smoother.autotune` for that
    launch shape before returning, so ``backend="auto"`` call sites of
    the shape take the measured winner from their first call. Cached per
    ``(spec_id, shape, platform)`` — repeated builds do not re-measure."""
    if spec is None:
        spec = SmootherSpec(**axes)
    elif axes:
        spec = dataclasses.replace(spec, **axes)
    smoother = Smoother(spec, device)
    if autotune_for is not None:
        smoother.autotune(*autotune_for)
    return smoother


# ---------------------------------------------------------------------------
# Public-API surface dump
# ---------------------------------------------------------------------------

def _describe(name: str, obj) -> list:
    """One deterministic line per exported name (methods get their own
    lines), in the JAX package's format."""
    import inspect

    if dataclasses.is_dataclass(obj) and isinstance(obj, type):
        fields = ", ".join(
            (f.name if f.default is dataclasses.MISSING
             else f"{f.name}={f.default!r}")
            for f in dataclasses.fields(obj))
        return [f"{name} = dataclass({fields})"]
    if isinstance(obj, type) and issubclass(obj, tuple) \
            and hasattr(obj, "_fields"):
        return [f"{name} = namedtuple({', '.join(obj._fields)})"]
    if isinstance(obj, type):
        lines = [f"{name} = class"]
        for m in sorted(vars(obj)):
            if m.startswith("_") and m != "__call__":
                continue
            member = inspect.getattr_static(obj, m)
            if isinstance(member, property):
                lines.append(f"{name}.{m} = property")
            elif callable(member):
                lines.append(f"{name}.{m}{inspect.signature(member)}")
        return lines
    if callable(obj):
        return [f"{name}{inspect.signature(obj)}"]
    return [f"{name} = constant"]


def dump_surface() -> str:
    """The public `repro_torch.core` surface as stable text, one line per
    name (dataclass fields and defaults, function signatures, class
    methods)."""
    import repro_torch.core as core

    lines = [f"# repro_torch.core public API surface "
             f"({len(core.__all__)} names)"]
    for name in sorted(core.__all__):
        lines.extend(_describe(name, getattr(core, name)))
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="repro_torch.core public-API tooling")
    p.add_argument("--dump-surface", action="store_true",
                   help="print the API surface snapshot text")
    args = p.parse_args(argv)
    if args.dump_surface:
        sys.stdout.write(dump_surface())
        return 0
    p.error("nothing to do (pass --dump-surface)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
