"""Carry a JAX-package model across to the port.

`state_space_model` turns a JAX ``StateSpaceModel``'s arrays (``Q``,
``R``, ``m0``, ``P0``, as numpy) and the scenario name into the port's
`StateSpaceModel` on a given device (the card unless the caller names
another, as every entry point of the port) and dtype. ``f`` and ``h`` are
rebuilt from the port's registered scenario config (callables do not
cross frameworks), so both packages compute on the same model.

`lm_params` turns the JAX LM's parameter pytree (as numpy) into the port's
`CausalLM` (the encoder-decoder's encoder and cross-attention too), so
both packages run the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


#: Each sequence mixer's ``[in, out]`` matrices (``nn.Linear``s in the
#: port); its other leaves are parameters as they are.
_MIXER_LINEAR = {"ssm": ("in_proj", "x_proj", "dt_w", "out_proj"),
                 "mlstm": ("in_proj", "wq", "wk", "wv", "w_gates",
                           "out_proj"),
                 "slstm": ("w_in", "up", "down")}


def lm_params(params, cfg, *, device: Device = None,
              dtype: Optional[torch.dtype] = None):
    """The port's `CausalLM` holding the JAX ``init_model`` parameters
    ``params`` (the pytree with its leaves as numpy arrays): ``embed``,
    ``runs`` (per run, each leaf stacked over the run's layers),
    ``final_norm``, ``lm_head`` and an encoder-decoder's ``encoder`` (a
    stacked dense run), ``enc_norm``, ``cross_attn`` (stacked over the
    decoder layers) and ``ln_cross``. The runs are unstacked into blocks
    (a hybrid block's ``ssm`` and ``ln_ssm`` too, an MoE block's ``moe``,
    an xLSTM block's ``mlstm`` or ``slstm``), ``encoder`` into dense
    blocks and ``cross_attn`` into one attention per layer;
    ``[in, out]`` matrices become ``nn.Linear`` weights ``[out, in]``, and
    the MoE's router and stacked experts stay as they are.
    On ``device`` (`resolve_device`), in ``dtype`` (default the config's
    parameter dtype). It first builds a random model of ``cfg``
    (`init_model`), so it is for the reduced configs only."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_model

    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype) if dtype is None else dtype
    model = init_model(cfg, 0, device=device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    state = {"embed": t(params["embed"]),
             "final_norm": t(params["final_norm"])}

    def attention(pre, attn, li):
        for name, w in attn.items():
            if name.startswith("w"):
                state[f"{pre}{name}.weight"] = t(w[li]).T
            else:  # bq, bk, bv
                state[f"{pre}w{name[1]}.bias"] = t(w[li])

    if "lm_head" in params:
        state["lm_head.weight"] = t(params["lm_head"]).T
    blocks = [(f"runs.{ri}.{li}.", run, li)
              for ri, run in enumerate(params["runs"])
              for li in range(len(model.runs[ri]))]
    if "encoder" in params:
        blocks += [(f"encoder.{li}.", params["encoder"], li)
                   for li in range(cfg.encoder_layers)]
        state["enc_norm"] = t(params["enc_norm"])
        state["ln_cross"] = t(params["ln_cross"])
        for li in range(cfg.num_layers):
            attention(f"cross_attn.{li}.", params["cross_attn"], li)
    for pre, run, li in blocks:
        for norm in ("ln1", "ln2", "ln_ssm"):
            if norm in run:
                state[pre + norm] = t(run[norm][li])
        attention(pre + "attn.", run.get("attn", {}), li)
        for name, w in run.get("mlp", {}).items():
            state[f"{pre}mlp.{name}.weight"] = t(w[li]).T
        for name, w in run.get("moe", {}).items():
            if name == "shared":  # [in, out] matrices of an MLP
                for sub, ws in w.items():
                    state[f"{pre}moe.shared.{sub}.weight"] = t(ws[li]).T
            else:  # router [d, E], experts [E, d, dff] / [E, dff, d]
                state[f"{pre}moe.{name}"] = t(w[li])
        for mixer, linear in _MIXER_LINEAR.items():
            for name, w in run.get(mixer, {}).items():
                if name in linear:
                    state[f"{pre}{mixer}.{name}.weight"] = t(w[li]).T
                else:  # conv_w, dt_bias, A_log, D, norm_w, r, b
                    state[f"{pre}{mixer}.{name}"] = t(w[li])
    model.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    return model.to(dtype)
