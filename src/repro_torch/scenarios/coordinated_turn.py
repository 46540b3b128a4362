"""Coordinated-turn model with bearings-only measurements (paper §5).

State ``x = [p_x, p_y, v_x, v_y, omega]`` with turn-rate dynamics, observed
through bearings from two fixed sensors (Bar-Shalom & Li, as in Särkkä &
Svensson 2020). Same configuration, guards and ``params`` as the JAX
package's scenario, so the registered ``model_id`` is the same string.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.types import StateSpaceModel

from .base import Scenario, register


@dataclasses.dataclass(frozen=True)
class CoordinatedTurnConfig:
    dt: float = 0.01
    q1: float = 0.1          # position/velocity process noise PSD
    q2: float = 0.1          # turn-rate process noise PSD
    r_std: float = 0.05      # bearing noise std (radians)
    # Sensors flank the trajectory, off the flight path (range -> 0 is
    # the bearings singularity that destabilizes plain Gauss-Newton).
    sensor1: Tuple[float, float] = (-1.5, 0.5)
    sensor2: Tuple[float, float] = (1.0, -1.0)
    m0: Tuple[float, ...] = (0.1, 0.2, 1.0, 0.0, 0.0)
    p0_diag: Tuple[float, ...] = (0.1, 0.1, 0.1, 0.1, 1.0)


def _turn_dynamics(dt: float):
    """Exact coordinated-turn transition, smooth at omega -> 0.

    Guarded denominators keep ``torch.func.jacfwd`` NaN-free: both
    ``where`` branches are evaluated under AD.
    """

    def f(x):
        px, py, vx, vy, w = x.unbind(-1)
        wd = w * dt
        small = torch.abs(wd) < 1e-6
        safe_wd = torch.where(small, torch.ones_like(wd), wd)
        # sin(w dt)/w and (1 - cos(w dt))/w with series fallbacks.
        swd = torch.where(small, dt * (1.0 - wd * wd / 6.0),
                          torch.sin(safe_wd) / safe_wd * dt)
        cwd = torch.where(small, dt * (wd / 2.0 - wd ** 3 / 24.0),
                          (1.0 - torch.cos(safe_wd)) / safe_wd * dt)
        cos_wd = torch.cos(wd)
        sin_wd = torch.sin(wd)
        return torch.stack([
            px + swd * vx - cwd * vy,
            py + cwd * vx + swd * vy,
            cos_wd * vx - sin_wd * vy,
            sin_wd * vx + cos_wd * vy,
            w,
        ], dim=-1)

    return f


def bearings_observation(sensor1, sensor2, dtype, device=None):
    """Two-sensor bearings map."""
    s1 = torch.tensor(sensor1, dtype=dtype, device=device)
    s2 = torch.tensor(sensor2, dtype=dtype, device=device)

    def h(x):
        return torch.stack([
            torch.atan2(x[..., 1] - s1[1], x[..., 0] - s1[0]),
            torch.atan2(x[..., 1] - s2[1], x[..., 0] - s2[0]),
        ], dim=-1)

    return h


def make_coordinated_turn_model(
        cfg: CoordinatedTurnConfig = CoordinatedTurnConfig(),
        dtype=torch.float64, device=None) -> StateSpaceModel:
    dt, q1, q2 = cfg.dt, cfg.q1, cfg.q2
    kw = dict(dtype=dtype, device=device)
    Q = torch.tensor([
        [q1 * dt ** 3 / 3, 0, q1 * dt ** 2 / 2, 0, 0],
        [0, q1 * dt ** 3 / 3, 0, q1 * dt ** 2 / 2, 0],
        [q1 * dt ** 2 / 2, 0, q1 * dt, 0, 0],
        [0, q1 * dt ** 2 / 2, 0, q1 * dt, 0],
        [0, 0, 0, 0, q2 * dt],
    ], **kw)
    R = (cfg.r_std ** 2) * torch.eye(2, **kw)
    m0 = torch.tensor(cfg.m0, **kw)
    P0 = torch.diag(torch.tensor(cfg.p0_diag, **kw))
    return StateSpaceModel(f=_turn_dynamics(dt),
                           h=bearings_observation(cfg.sensor1, cfg.sensor2,
                                                  dtype, device),
                           Q=Q, R=R, m0=m0, P0=P0)


_CFG = CoordinatedTurnConfig()

register(Scenario(
    name="coordinated_turn",
    build=lambda dtype=torch.float64, device=None:
        make_coordinated_turn_model(_CFG, dtype, device),
    nx=5, ny=2,
    default_method="ekf",
    lm_lambda=1.0,   # undamped GN diverges beyond ~300 steps
    description="Paper §5: coordinated-turn dynamics, two-sensor "
                "bearings-only observations.",
    params=(("dt", _CFG.dt), ("q1", _CFG.q1), ("q2", _CFG.q2),
            ("r_std", _CFG.r_std),
            ("sensor1", _CFG.sensor1), ("sensor2", _CFG.sensor2),
            ("m0", _CFG.m0), ("p0_diag", _CFG.p0_diag)),
))
