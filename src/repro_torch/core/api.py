"""Unified estimator API: one declarative `SmootherSpec` + `build_smoother`.

`SmootherSpec` has the JAX package's fields, order, defaults and
validation, so :attr:`SmootherSpec.spec_id` is the same string in both
packages for equal fields — routes and autobatch signatures are shared.
`build_smoother(spec, device=...)` returns a `Smoother` bound to a device
(``cuda`` unless the caller names another; it raises on a host without a
card rather than falling back to the CPU). Its methods take batched
inputs ``ys [B, n, ny]``; a single trajectory ``[n, ny]`` runs as B=1.

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

import dataclasses
import hashlib
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

    def iterated_config(self) -> IteratedConfig:
        """The execution `IteratedConfig` (``model_id`` = ``spec_id``)."""
        return IteratedConfig(
            method=self.method, n_iter=self.n_iter,
            parallel=self.mode == "parallel",
            sigma_scheme=self.sigma_scheme, lm_lambda=self.lm_lambda,
            combine_impl=self.combine_impl, jitter=self.jitter,
            tol=self.tol, model_id=self.spec_id, form=self.form,
            damping=self.damping, backend=self.backend)


def _single(x: torch.Tensor, batched: bool) -> torch.Tensor:
    return x if batched else x[0]


class Smoother:
    """Configured estimator built by :func:`build_smoother`, bound to one
    device. ``ys [B, n, ny]`` runs the batched path; ``ys [n, ny]`` runs
    as B=1 and comes back without the batch axis. Calling the object is
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
        """``(B, T, nx)`` of a batched call site (None for a single
        trajectory) — the ``backend="auto"`` autotune-cache key."""
        if ys.ndim != 3:
            return None
        return (int(ys.shape[0]), int(ys.shape[1]), int(m0.shape[-1]))

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
        ``[B, n, ...]`` for batched ``lin``/``ys``."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if not batched:
            lin, ys = LinearizedSSM(*(x[None] for x in lin)), ys[None]
        if self.spec.mode == "sequential":
            out = _sequential.kalman_filter_batched(lin, ys, m0, P0)
        elif self.spec.form == "sqrt":
            out = _sqrt.sqrt_parallel_filter_batched(lin, ys, m0, P0)
        else:
            out = _parallel.parallel_filter_batched(
                lin, ys, m0, P0, combine_impl=self._combine_impl(ys, m0))
        return Gaussian(*(_single(x, batched) for x in out))

    def smooth(self, lin: LinearizedSSM, ys, m0, P0):
        """One filtering + smoothing pass: ``(filtered, smoothed)``,
        smoothed with ``n + 1`` rows."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if not batched:
            lin, ys = LinearizedSSM(*(x[None] for x in lin)), ys[None]
        if self.spec.mode == "sequential":
            filt, smth = _sequential._filter_smoother_batched(lin, ys, m0, P0)
        elif self.spec.form == "sqrt":
            filt, smth = _sqrt._sqrt_parallel_filter_smoother_batched(
                lin, ys, m0, P0)
        else:
            filt, smth = _parallel._parallel_filter_smoother_batched(
                lin, ys, m0, P0, combine_impl=self._combine_impl(ys, m0))
        return (Gaussian(*(_single(x, batched) for x in filt)),
                Gaussian(*(_single(x, batched) for x in smth)))

    # -- the full iterated smoother ----------------------------------------

    def iterate(self, model, ys, init: Optional[Gaussian] = None,
                return_history: bool = False, return_info: bool = False):
        """Run up to ``n_iter`` linearize->filter->smooth passes
        (early-stopped under ``tol``, per-lane adaptive damping under
        ``damping="adaptive"``): ``[B, n + 1, ...]`` marginals, then the
        mean history ``[n_iter, B, n + 1, nx]`` with
        ``return_history=True`` and the per-lane `LaneStatus` with
        ``return_info=True``."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if not batched:
            ys = ys[None]
            init = None if init is None else Gaussian(*(x[None] for x in init))
        out = _iterated._iterated_smoother_batched(
            model, ys, self.config, init=init,
            return_history=return_history, return_info=return_info)
        if batched:
            return out
        if not (return_history or return_info):
            return Gaussian(*(x[0] for x in out))
        out = list(out)
        out[0] = Gaussian(*(x[0] for x in out[0]))
        if return_history:
            out[1] = out[1][:, 0]
        if return_info:
            out[-1] = type(out[-1])(*(x[0] for x in out[-1]))
        return tuple(out)

    __call__ = iterate

    def log_likelihood(self, model, ys, traj: Gaussian,
                       per_step: bool = False) -> torch.Tensor:
        """Measurement log-likelihood of ``ys`` under the smoothed
        posterior ``traj``: ``[B]``, or per-step ``[B, n]``."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if not batched:
            ys, traj = ys[None], Gaussian(*(x[None] for x in traj))
        return _single(_iterated.smoothed_log_likelihood(
            model, ys, traj, self.config, per_step=per_step), batched)

    def cost(self, model, ys, traj: Gaussian) -> torch.Tensor:
        """Gauss-Newton smoothing cost of ``traj`` (`core.cost.gn_cost`)."""
        self._check_device(ys)
        batched = ys.ndim == 3
        if not batched:
            ys, traj = ys[None], Gaussian(*(x[None] for x in traj))
        return _single(_cost.gn_cost(model, ys, traj, self.spec.method,
                                     self.spec.sigma_scheme,
                                     self.spec.jitter), batched)


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
