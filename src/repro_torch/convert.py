"""Carry a JAX-package model across to the port.

`state_space_model` turns a JAX ``StateSpaceModel``'s arrays (``Q``,
``R``, ``m0``, ``P0``, as numpy) and the scenario name into the port's
`StateSpaceModel` on a given device (the card unless the caller names
another, as every entry point of the port) and dtype. ``f`` and ``h`` are
rebuilt from the port's registered scenario config (callables do not
cross frameworks), so both packages compute on the same model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import Device, StateSpaceModel, resolve_device
from repro_torch.scenarios import get_scenario


def state_space_model(scenario: str, Q: np.ndarray, R: np.ndarray,
                      m0: np.ndarray, P0: np.ndarray, *,
                      device: Device = None,
                      dtype: torch.dtype = torch.float64) -> StateSpaceModel:
    """The port's model for ``scenario`` with the given noise and prior, on
    ``device`` (`resolve_device`: the card by default; raises without one
    unless ``device="cpu"``)."""
    device = resolve_device(device)
    base = get_scenario(scenario).make_model(dtype, device)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                     device=device)
    return dataclasses.replace(base, Q=as_t(Q), R=as_t(R), m0=as_t(m0),
                               P0=as_t(P0))
