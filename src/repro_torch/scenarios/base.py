"""Scenario registry: named nonlinear SSM setups behind one contract.

A :class:`Scenario` bundles a model factory (``build(dtype, device) ->
StateSpaceModel``), the ground-truth simulator, the default linearization
and damping, and a stable ``model_id`` — a content hash of the scenario
name and its numeric parameters, byte-identical to the JAX package's, so
``spec_id`` and the autobatch bucket signatures agree across the two
packages. Registration is import-time: each scenario module calls
:func:`register`.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.api import SmootherSpec
from repro_torch.core.types import StateSpaceModel


def _batched(fn: Callable, lead: int) -> Callable:
    """``fn`` (one state vector) mapped over ``lead`` leading axes."""
    for _ in range(lead):
        fn = torch.func.vmap(fn)
    return fn


def rollout(model: StateSpaceModel, x0: torch.Tensor, qs: torch.Tensor,
            rs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic rollout ``x_k = f(x_{k-1}) + q_k``, ``y_k = h(x_k) +
    r_k`` from given noise. ``x0 [..., nx]``, ``qs [..., n, nx]``,
    ``rs [..., n, ny]`` (any leading axes, shared by all three); returns
    ``(xs [..., n+1, nx], ys [..., n, ny])``."""
    lead = x0.ndim - 1
    f, h = _batched(model.f, lead), _batched(model.h, lead)
    x, xs, ys = x0, [x0], []
    for k in range(qs.shape[-2]):
        x = f(x) + qs[..., k, :]
        xs.append(x)
        ys.append(h(x) + rs[..., k, :])
    return torch.stack(xs, dim=-2), torch.stack(ys, dim=-2)


def simulate_trajectory(model: StateSpaceModel, n: int,
                        generator: torch.Generator, batch: Tuple[int, ...] = ()
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``x_{0:n}`` and ``y_{1:n}`` from an additive-Gaussian model,
    on the model's device, from ``generator`` (which must live there).
    ``batch`` prepends independent trajectories. Returns
    ``(xs [*batch, n+1, nx], ys [*batch, n, ny])``."""
    kw = dict(dtype=model.m0.dtype, device=model.device, generator=generator)
    cholQ = torch.linalg.cholesky(model.Q)
    cholR = torch.linalg.cholesky(model.R)
    cholP0 = torch.linalg.cholesky(model.P0)
    x0 = model.m0 + torch.randn(batch + (model.nx,), **kw) @ cholP0.mT
    qs = torch.randn(batch + (n, model.nx), **kw) @ cholQ.mT
    rs = torch.randn(batch + (n, model.ny), **kw) @ cholR.mT
    return rollout(model, x0, qs, rs)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered nonlinear state-space scenario.

    ``params`` is the flat ``(name, value)`` tuple of every numeric knob
    that shapes the model — the hashed content of ``model_id``.
    """

    name: str
    build: Callable[..., StateSpaceModel]   # build(dtype, device) -> model
    nx: int
    ny: int
    default_method: str = "ekf"             # "ekf" | "slr"
    sigma_scheme: str = "cubature"          # for method="slr"
    lm_lambda: float = 0.0                  # production damping default
    description: str = ""
    params: Tuple[Tuple[str, object], ...] = ()

    @property
    def model_id(self) -> str:
        """Stable content signature: ``<name>:<sha1[:8] of name+params>``
        (the JAX package's exact recipe)."""
        blob = self.name + "".join(
            f";{k}={v!r}" for k, v in self.params)
        digest = hashlib.sha1(blob.encode()).hexdigest()[:8]
        return f"{self.name}:{digest}"

    def make_model(self, dtype=torch.float64, device=None) -> StateSpaceModel:
        return self.build(dtype, device)

    def simulate(self, model: StateSpaceModel, n: int,
                 generator: torch.Generator
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return simulate_trajectory(model, n, generator)

    def default_spec(self, **overrides) -> SmootherSpec:
        """The scenario's production `SmootherSpec` (default
        linearization, sigma scheme, damping and ``model_id``); keyword
        overrides replace any spec field."""
        kw = dict(
            linearization=("taylor" if self.default_method == "ekf"
                           else "slr"),
            sigma_scheme=self.sigma_scheme,
            lm_lambda=self.lm_lambda,
            model_id=self.model_id)
        kw.update(overrides)
        return SmootherSpec(**kw)


_REGISTRY: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (import-time; name must be new)."""
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"available: {list_scenarios()}") from e


def list_scenarios() -> List[str]:
    return sorted(_REGISTRY)
