"""Carry a JAX-package model across to the port.

`state_space_model` turns a JAX ``StateSpaceModel``'s arrays (``Q``,
``R``, ``m0``, ``P0``, as numpy) and the scenario name into the port's
`StateSpaceModel` on a given device (the card unless the caller names
another, as every entry point of the port) and dtype. ``f`` and ``h`` are
rebuilt from the port's registered scenario config (callables do not
cross frameworks), so both packages compute on the same model.

`lm_params` turns the JAX LM's parameter pytree (as numpy) into the port's
`CausalLM` (the encoder-decoder's encoder and cross-attention too), so
both packages run the same weights. `lm_tree` lays out any pytree shaped
like those parameters (gradients, AdamW's moments) by the port's
parameter names, and `jax_path` gives each port parameter the path the
reference's optimizer decides weight decay on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


def jax_leaf(name: str):
    """Where the port's parameter ``name`` (a `CausalLM` state-dict key)
    lives in the JAX ``init_model`` pytree: (the keys down to its leaf,
    the layer index into that leaf's stacked first axis or None, whether
    the port holds it transposed). A block of run ``ri`` (``runs.ri.li``)
    is layer ``li`` of ``params["runs"][ri]``; an encoder block and a
    cross-attention are layer ``li`` of ``params["encoder"]`` and
    ``params["cross_attn"]``; an ``nn.Linear``'s ``weight`` is the
    reference's ``[in, out]`` matrix transposed and an attention
    projection's ``w?.bias`` its ``b?``. Every other leaf has the
    reference's name and layout."""
    parts = name.split(".")
    layer = None
    if parts[0] == "runs":
        keys, layer, rest = ["runs", int(parts[1])], int(parts[2]), parts[3:]
    elif parts[0] in ("encoder", "cross_attn"):
        keys, layer, rest = [parts[0]], int(parts[1]), parts[2:]
    else:
        keys, rest = [], parts
    transposed = rest[-1] == "weight"
    if transposed:
        rest = rest[:-1]
    elif rest[-1] == "bias" and len(rest) > 1:
        rest = rest[:-2] + ["b" + rest[-2][1:]]
    return tuple(keys + rest), layer, transposed


def jax_path(name: str) -> str:
    """The path of the port's parameter ``name`` as the reference's
    optimizer spells it (``repro.optim.adamw._decay_mask``): its keys
    joined by "/", a list index (the run) as the empty string, so block
    ``li`` of run 0's ``attn.wq.bias`` is ``runs//attn/bq``."""
    keys, _, _ = jax_leaf(name)
    return "/".join("" if isinstance(k, int) else k for k in keys)


def lm_tree(tree, names) -> Dict[str, np.ndarray]:
    """Any pytree shaped like the JAX LM's parameters (the parameters,
    their gradients, AdamW's moments; leaves as numpy arrays or anything
    ``np.asarray`` takes) in the port's layout: ``{name: array}`` for each
    port parameter name in ``names`` (`jax_leaf`)."""
    out = {}
    for name in names:
        keys, layer, transposed = jax_leaf(name)
        leaf = tree
        for k in keys:
            leaf = leaf[k]
        leaf = np.asarray(leaf)
        if layer is not None:
            leaf = leaf[layer]
        out[name] = leaf.T if transposed else leaf
    return out


def lm_params(params, cfg, *, device: Device = None,
              dtype: Optional[torch.dtype] = None, mesh=None):
    """The port's `CausalLM` holding the JAX ``init_model`` parameters
    ``params`` (the pytree with its leaves as numpy arrays), each leaf
    placed by `lm_tree`: the runs unstacked into blocks, ``encoder`` into
    dense blocks and ``cross_attn`` into one attention per layer,
    ``[in, out]`` matrices as ``nn.Linear`` weights ``[out, in]``, the
    MoE's router and stacked experts as they are. On ``device``
    (`resolve_device`), in ``dtype`` (default the config's parameter
    dtype). It first builds a random model of ``cfg`` (`init_model`), so
    it is for the reduced configs only.

    With ``mesh`` (a `repro_torch.distributed.Mesh`, on one of its
    ranks), a dense, hybrid or encoder-decoder config that runs
    tensor-parallel on it (in every plan, decode's too:
    `launch.sharding.tensor_parallel`) becomes the rank's compute model:
    the reference's "model" block of every weight, an SSM's ``in_proj``
    its block of each half (`launch.sharding.shard_tensor_parallel`),
    which the plans of that mesh bind as it is. Otherwise every MoE layer keeps only what the
    rank's coordinate on "model" holds for the expert-parallel dispatch
    (`moe.shard_model`): its ``E / tp`` experts and its shards of the
    shared experts, and every other weight is whole on every rank."""
    from repro_torch.launch import sharding as shard_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_model

    device = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype) if dtype is None else dtype
    model = init_model(cfg, 0, device=device)
    state = lm_tree(params, model.state_dict().keys())
    model.load_state_dict({
        k: torch.tensor(np.asarray(v, np.float32), device=device).to(dtype)
        for k, v in state.items()})
    if mesh is not None and shard_lib.tensor_parallel(cfg, mesh, "decode"):
        shard_lib.shard_tensor_parallel(model, cfg, mesh)
    elif mesh is not None:
        moe_lib.shard_model(model, cfg, mesh)
    return model.to(dtype)
