"""Sharding tables: the JAX package's ``repro.launch.sharding`` for the
port's model — every parameter's `PartitionSpec`, their adaptation to a
multi-pod mesh, FSDP widening for the largest archs, and the batch
specs of the train step.

The specs are the reference's, taken leaf by leaf from the layout its
``init_model`` returns (`jax_spec_tree`, its rules kept here as a copy:
the port imports nothing of the JAX package). The reference stacks the
layers of a run on a leading dimension; the port holds one tensor per
layer, so a layer's spec drops that entry, and an
``nn.Linear`` weight (the reference's ``[in, out]`` matrix transposed)
takes its spec reversed (`convert.jax_leaf`). Rules that depend on the
shapes (`fsdp_widen`, ``optim.zero_specs``) run on the reference's
stacked shapes (`jax_layout`), so they pick the dimensions it picks,
and their results are then carried to the port's layout (`to_port`).

Shapes come from the model built on the ``meta`` device, which
allocates nothing (the reference's ``eval_shape``).

Tensor parallelism (`tensor_parallel`, `tp_compute_specs`,
`shard_tensor_parallel`): on a mesh whose "model" axis has more than one
rank, the compute blocks of a dense, hybrid or encoder-decoder model are
the reference's parameter specs with the batch axes taken out and
"model" kept, so each rank holds and computes the reference's "model"
block of every layer, as GSPMD runs it (Megatron's layout: attention
heads, the MLP's ``d_ff``, the SSM's ``d_inner`` channels, the encoder's
blocks and the cross-attention's heads, and the padded vocabulary of the
embedding and head split over "model").

One weight computes on another block than it rests in: the SSM's
``in_proj`` ``[d, 2 d_inner]`` (columns ``[x | z]``), which the
reference splits as one contiguous run of columns over "model" (at
"model" 2, rank 0 rests with all of ``x`` and rank 1 with all of
``z``), while a rank computing on its ``d_inner`` channels needs its
block of each half, ``[x_r ; z_r]`` (`split_halves`). GSPMD moves the
activations after ``xz[..., :d_inner]``; the port moves the weight
instead: the compute block is exchanged from the resting block over
"model" when the compute model is loaded, and a gradient takes the same
way back (`to_halves`, `from_halves`: `distributed.exchange_rows`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import (NamedSharding, P, PartitionSpec,
                                     exchange_rows, map_specs, shape_of,
                                     widen_spec)

# ---------------------------------------------------------------------------
# The reference's specs, in its layout
# ---------------------------------------------------------------------------


def _attention_specs(cfg: ModelConfig) -> dict:
    kv = "model" if cfg.shard_kv_heads else None
    specs = {"wq": P(None, "model"), "wk": P(None, kv), "wv": P(None, kv),
             "wo": P("model", None)}
    if cfg.qkv_bias:
        specs.update(bq=P("model"), bk=P(kv), bv=P(kv))
    return specs


def _mlp_specs() -> dict:
    return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
            "w_down": P("model", None)}


def _moe_specs(cfg: ModelConfig) -> dict:
    if cfg.num_experts % cfg.tp_size == 0:
        e, f, d2 = "model", None, None
    else:
        e, f, d2 = None, "model", "data"
    specs = {"router": P(None, None), "w_gate": P(e, d2, f),
             "w_up": P(e, d2, f), "w_down": P(e, f, d2)}
    if cfg.num_shared_experts:
        specs["shared"] = _mlp_specs()
    return specs


def _ssm_specs() -> dict:
    return {"in_proj": P(None, "model"), "conv_w": P(None, "model"),
            "x_proj": P("model", None), "dt_w": P(None, "model"),
            "dt_bias": P("model"), "A_log": P("model", None),
            "D": P("model"), "out_proj": P("model", None)}


def _mlstm_specs() -> dict:
    return {"in_proj": P(None, "model"), "conv_w": P(None, "model"),
            "wq": P(None, "model"), "wk": P(None, "model"),
            "wv": P(None, "model"), "w_gates": P(None, None),
            "norm_w": P("model"), "out_proj": P("model", None)}


def _slstm_specs() -> dict:
    return {"w_in": P(None, "model"), "r": P(None, None, "model"),
            "b": P("model"), "up": P(None, "model"),
            "down": P("model", None), "norm_w": P(None)}


def _block_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("dense", "moe", "hybrid"):
        specs = {"ln1": P(None), "attn": _attention_specs(cfg),
                 "ln2": P(None)}
        if kind == "moe":
            specs["moe"] = _moe_specs(cfg)
        else:
            specs["mlp"] = _mlp_specs()
        if kind == "hybrid":
            specs.update(ssm=_ssm_specs(), ln_ssm=P(None))
        return specs
    if kind == "mlstm":
        return {"ln1": P(None), "mlstm": _mlstm_specs()}
    if kind == "slstm":
        return {"ln1": P(None), "slstm": _slstm_specs()}
    raise ValueError(kind)


def _stacked(tree):
    """A run's specs: every leaf with the leading (layer) entry None."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return P(None, *tree)


def jax_spec_tree(cfg: ModelConfig) -> dict:
    """The specs tree the reference's ``init_model(cfg, key)`` returns:
    ``embed``, ``runs`` (a list, one stacked tree per run of the layer
    schedule), ``final_norm``, ``lm_head`` unless tied, and the
    encoder-decoder's ``encoder``, ``enc_norm``, ``cross_attn`` and
    ``ln_cross``."""
    from repro_torch.models.blocks import layer_schedule

    specs: Dict[str, Any] = {
        "embed": P("model", None),
        "runs": [_stacked(_block_specs(cfg, run.kind))
                 for run in layer_schedule(cfg)],
        "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "model")
    if cfg.encoder_layers:
        specs["encoder"] = _stacked(_block_specs(cfg, "dense"))
        specs["enc_norm"] = P(None)
        specs["cross_attn"] = _stacked(_attention_specs(cfg))
        specs["ln_cross"] = P(None, None)
    return specs


# ---------------------------------------------------------------------------
# Shapes, and the two layouts
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: the model's
    init then allocates nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_model(cfg: ModelConfig):
    """The port's model of ``cfg`` on the ``meta`` device: names, shapes
    and dtypes, no storage."""
    from repro_torch.models.transformer import CausalLM

    with torch.no_grad():
        return CausalLM(cfg, _MetaGenerator())


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[torch.Size,
                                                      torch.dtype]]:
    """``{name: (shape, dtype)}`` of every parameter of the port's model,
    in ``named_parameters`` order, without allocating."""
    return dict(_param_shapes(cfg))


@functools.lru_cache(maxsize=16)
def _param_shapes(cfg: ModelConfig):
    # A meta build of the largest archs takes about a second; plans ask
    # for the same configs' shapes again and again.
    return {n: (p.shape, p.dtype)
            for n, p in meta_model(cfg).named_parameters()}


class JaxLeaf:
    """One leaf of the reference's parameter pytree: its keys, its
    stacked shape, dtype and spec, and the port parameters it holds
    (one per layer of a run, in layer order)."""

    def __init__(self, keys, shape, dtype, spec, stacked, transposed):
        self.keys, self.shape, self.dtype = keys, tuple(shape), dtype
        self.spec, self.stacked, self.transposed = spec, stacked, transposed
        self.names = []

    def __repr__(self) -> str:
        return f"JaxLeaf({'/'.join(map(str, self.keys))}, {self.shape}, " \
               f"{self.spec})"


def _lookup(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def jax_layout(cfg: ModelConfig, specs: Optional[dict] = None
               ) -> Dict[tuple, JaxLeaf]:
    """The reference's leaves, keyed by their keys: stacked shapes (from
    the port's meta model, put back in the reference's layout) and specs
    from ``specs`` (default `jax_spec_tree`)."""
    specs = jax_spec_tree(cfg) if specs is None else specs
    leaves: Dict[tuple, JaxLeaf] = {}
    for name, (shape, dtype) in param_shapes(cfg).items():
        keys, layer, transposed = convert.jax_leaf(name)
        shape = tuple(shape)[::-1] if transposed else tuple(shape)
        leaf = leaves.get(keys)
        if leaf is None:
            leaf = leaves[keys] = JaxLeaf(keys, shape, dtype,
                                          _lookup(specs, keys),
                                          layer is not None, transposed)
        leaf.names.append(name)
    for leaf in leaves.values():
        if leaf.stacked:
            leaf.shape = (len(leaf.names),) + leaf.shape
    return leaves


def to_port(spec: PartitionSpec, stacked: bool, transposed: bool,
            ndim: int) -> PartitionSpec:
    """A spec of the reference's leaf as the spec of one port parameter
    of ``ndim`` dimensions: the stacked entry dropped, reversed for a
    transposed weight. Where the reference shards the stacked layer
    dimension itself (`fsdp_widen` picks it for a stacked bias), a single
    layer cannot be cut that way: the port holds each layer whole over
    those axes (more bytes per rank than the reference's; see
    ``TrainPlan.resident_bytes``)."""
    entries = list(spec) + [None] * (ndim + stacked - len(spec))
    if stacked:
        entries = entries[1:]
    if transposed:
        entries = entries[::-1]
    return P(*entries)


def port_specs(leaves: Dict[tuple, JaxLeaf],
               specs_of=lambda leaf: leaf.spec) -> Dict[str, PartitionSpec]:
    """``{port name: spec}`` from per-leaf specs of the reference's
    layout (``specs_of(leaf)``, default the leaf's own)."""
    out = {}
    for leaf in leaves.values():
        ndim = len(leaf.shape) - leaf.stacked
        spec = to_port(specs_of(leaf), leaf.stacked, leaf.transposed, ndim)
        for name in leaf.names:
            out[name] = spec
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, PartitionSpec]:
    """The spec of every parameter of the port's model (``{name:
    spec}``, in ``named_parameters`` order): the reference's spec of the
    leaf it comes from (`jax_spec_tree`, `to_port`)."""
    order = list(param_shapes(cfg))
    specs = port_specs(jax_layout(cfg))
    return {n: specs[n] for n in order}


# ---------------------------------------------------------------------------
# The reference's rules on specs
# ---------------------------------------------------------------------------

def _map_entry(e, mapping):
    if e is None:
        return None
    if isinstance(e, str):
        return mapping.get(e, e)
    if "pod" in e:
        return e  # already multi-pod aware; don't re-map 'data'
    return tuple(x for part in e for x in (
        mapping.get(part, part) if isinstance(mapping.get(part, part),
                                              tuple)
        else (mapping.get(part, part),)))


def adapt_specs_for_mesh(specs: Any, mesh) -> Any:
    """Make single-pod specs portable: on a multi-pod mesh, 'data' means
    the combined ('pod', 'data') axes (pure DP over pods). ``specs``: a
    spec or any nesting of dicts, lists and tuples of them."""
    if "pod" not in mesh.axis_names:
        return specs
    mapping = {"data": ("pod", "data")}
    return map_specs(lambda s: P(*[_map_entry(e, mapping) for e in s]),
                     specs)


def fsdp_widen(specs: Any, shapes: Any, data_size: int = 16) -> Any:
    """FSDP: additionally shard the largest divisible unsharded dim of
    every >= 2-D weight over 'data' (the ~70B+ archs in train, where 1-D
    TP-sharded params + grads exceed HBM). ``specs`` and ``shapes`` (of
    sizes, or of anything with a ``.shape``) nest alike."""

    def one(spec, like):
        shape = shape_of(like)
        return spec if len(shape) < 2 else widen_spec(spec, shape, data_size)

    return map_specs(one, specs, shapes)


def named(mesh, specs: Any) -> Any:
    """A spec pytree as a `NamedSharding` pytree on ``mesh``, the specs
    adapted to it first (`adapt_specs_for_mesh`)."""
    return map_specs(lambda s: NamedSharding(mesh, s),
                     adapt_specs_for_mesh(specs, mesh))


def eval_shapes_init(cfg: ModelConfig):
    """The parameters' abstract shapes and specs, nothing allocated: ``(
    {name: (shape, dtype)}, {name: spec})`` of the port's model, from
    its ``meta`` build (the reference's ``eval_shape`` of ``init_model``)."""
    return param_shapes(cfg), param_specs(cfg)


def train_batch_specs(cfg: ModelConfig, batch_axis=("data",)) -> dict:
    specs = {"tokens": P(batch_axis, None), "labels": P(batch_axis, None)}
    if cfg.encoder_layers:
        specs["enc_emb"] = P(batch_axis, None, None)
    return specs


def residual_spec(batch_axis=("data",), seq_axis="model") -> PartitionSpec:
    """Megatron-style sequence-parallel residual stream (train path). A
    layout hint to GSPMD in the reference; in the port a tensor-parallel
    model (`tensor_parallel`) holds its residual stream so where the
    train and prefill plans ask for it (``sequence_parallel``,
    `models.train_loss`; an encoder's stream too), and the other
    families hold it replicated over "model"."""
    return P(batch_axis, seq_axis, None)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

#: The families whose layers run tensor-parallel over "model" (the MoE's
#: experts and xLSTM's mixers keep the replicated compute model).
TP_FAMILIES = ("dense", "hybrid", "encdec")


def kv_heads_split(cfg: ModelConfig, mesh) -> bool:
    """Whether a rank's compute blocks hold its block of the kv heads: the
    reference splits them where ``cfg.shard_kv_heads`` holds, and the
    mesh's "model" axis must divide them too; else ``wk``/``wv`` are
    whole on every rank (replicated, or gathered where they rest split)."""
    return cfg.shard_kv_heads and \
        cfg.num_kv_heads % mesh.shape.get("model", 1) == 0


def tensor_parallel(cfg: ModelConfig, mesh, kind: str = "train") -> bool:
    """Whether a plan of ``kind`` on ``mesh`` runs its layers
    tensor-parallel over "model": a dense, hybrid or encoder-decoder
    config (`TP_FAMILIES`, no experts), "model" of more than one rank
    dividing the padded q heads, ``d_ff``, the padded vocabulary and a
    hybrid's ``d_inner``, and in decode kv heads that split over "model"
    as its caches do (`kv_heads_split`) or rest replicated."""
    if mesh is None:
        return False
    tp = mesh.shape.get("model", 1)
    if tp == 1 or cfg.family not in TP_FAMILIES or cfg.num_experts:
        return False
    if cfg.padded_heads % tp or cfg.d_ff % tp or cfg.padded_vocab % tp:
        return False
    if cfg.family == "hybrid" and (cfg.ssm_expand * cfg.d_model) % tp:
        return False
    return kind != "decode" or kv_heads_split(cfg, mesh) == \
        cfg.shard_kv_heads


def tp_compute_specs(cfg: ModelConfig, mesh,
                     pspecs: Dict[str, PartitionSpec]
                     ) -> Dict[str, PartitionSpec]:
    """What a tensor-parallel rank's compute model holds of each parameter
    (port specs ``pspecs`` by name): its spec with every axis but "model"
    taken out (an FSDP or multi-pod batch axis is gathered), and the k/v
    projections whole where the kv heads do not split (`kv_heads_split`).
    A `split_halves` weight's "model" entry there means its block of each
    half (`halves_block`)."""
    whole_kv = not kv_heads_split(cfg, mesh)
    out = {}
    for n, spec in pspecs.items():
        kv = n.split(".")[-2:-1] in (["wk"], ["wv"])
        out[n] = P(*[e if e == "model" and not (whole_kv and kv) else None
                     for e in spec])
    return out


def split_halves(name: str) -> bool:
    """Whether a tensor-parallel rank computes on its block of each half of
    the parameter's first dimension, where the reference rests it as one
    contiguous block over "model": an SSM's ``in_proj`` (module
    docstring)."""
    return name.endswith("ssm.in_proj.weight")


def _rest_rows(n: int, size: int, i: int) -> range:
    """The rows of ``n`` that axis index ``i`` of ``size`` rests with: one
    contiguous block."""
    return range(i * n // size, (i + 1) * n // size)


def _halves_rows(n: int, size: int, i: int) -> list:
    """The rows of ``n`` that axis index ``i`` of ``size`` computes on:
    its block of each half."""
    h, c = n // 2, n // (2 * size)
    return list(range(i * c, (i + 1) * c)) + list(range(h + i * c,
                                                        h + (i + 1) * c))


def halves_block(full: torch.Tensor, mesh, axis: str = "model"
                 ) -> torch.Tensor:
    """A rank's compute block ``[x_r ; z_r]`` of a whole `split_halves`
    weight: its block of each half of the first dimension (a copy)."""
    rows = _halves_rows(full.shape[0], mesh.shape[axis], mesh.coords[axis])
    return full.index_select(0, torch.tensor(rows, device=full.device))


def to_halves(rest: torch.Tensor, mesh, axis: str = "model"
              ) -> torch.Tensor:
    """A `split_halves` weight's compute block from the rank's resting
    block over ``axis`` (its contiguous block): an exchange of rows
    between the ranks of the axis (`distributed.exchange_rows`)."""
    n, D = rest.shape[0] * mesh.shape[axis], mesh.shape[axis]
    return exchange_rows(rest, mesh, axis,
                         lambda i: _rest_rows(n, D, i),
                         lambda i: _halves_rows(n, D, i))


def from_halves(block: torch.Tensor, mesh, axis: str = "model"
                ) -> torch.Tensor:
    """The inverse of `to_halves`: the rank's resting block of a
    `split_halves` weight (or of its gradient) from its compute block."""
    n, D = block.shape[0] * mesh.shape[axis], mesh.shape[axis]
    return exchange_rows(block, mesh, axis,
                         lambda i: _halves_rows(n, D, i),
                         lambda i: _rest_rows(n, D, i))


def shard_tensor_parallel(model, cfg: ModelConfig, mesh,
                          specs: Optional[Dict[str, PartitionSpec]] = None
                          ) -> None:
    """Make ``model`` (whole, on this rank of ``mesh``) the rank's
    tensor-parallel compute model, in place: each parameter cut to its
    block under ``specs`` (default `tp_compute_specs` of the reference's
    specs; a `split_halves` weight to its block of each half), and the
    model, its blocks, attentions, MLPs and SSMs marked with the axis
    (``tp_axis``) they split over. A model marked already is left as it
    is."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.blocks import Block
    from repro_torch.models.mlp import MLP
    from repro_torch.models.ssm import SSM

    if getattr(model, "tp_axis", None) is not None:
        return
    if specs is None:
        specs = tp_compute_specs(cfg, mesh, param_specs(cfg))
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if split_halves(name):
                block = halves_block(p, mesh)
            else:
                block = NamedSharding(mesh, specs[name]).block(p)
            if block.shape == p.shape:
                continue
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, leaf, torch.nn.Parameter(
                block.clone(), requires_grad=p.requires_grad))
    model.tp_axis = "model"
    for m in model.modules():
        if isinstance(m, (Attention, Block, MLP, SSM)):
            m.tp_axis = "model"
