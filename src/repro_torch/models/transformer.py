"""The causal LM and the encoder-decoder LM (PyTorch): init, encode,
prefill, decode.

The JAX package's ``repro.models.transformer`` for all five families
(dense, hybrid, MoE, xLSTM and encoder-decoder). Its functional API, with
an ``nn.Module`` in place of the parameter pytree:

    model = init_model(cfg, seed, device=...)
    memory = encode(model, cfg, enc_emb)              # encoder-decoder
    loss, metrics = train_loss(model, cfg, batch)
    logits = prefill(model, cfg, tokens[, enc_emb])
    logits, caches = decode_step(model, cfg, caches, tokens, pos[, memory])

An encoder-decoder config (``cfg.encoder_layers``) adds a non-causal dense
encoder over the stub frontend's embeddings ``enc_emb [B, S, d]`` and, in
every decoder layer after its self-attention and MLP block, a
cross-attention sublayer against the encoder memory; its K/V are projected
from the memory anew in every layer of every decode step, as in the
reference. `train_loss` is the training forward under autograd, on the
plain versions. The MoE layers' load-balance losses are summed by
`_apply_stack` (training reads them; `prefill` and `decode_step` drop
them, as the reference's do). ``impl``
(``"auto"`` or ``"plain"``) says where attention and the SSM and mLSTM
scans run (`models.attention`, `models.ssm`, `models.xlstm`): ``"auto"``
runs the CUDA kernels on the card. Decode writes the caches in place and
returns them with the attention caches' lengths advanced.

Tensor parallelism (a dense, hybrid or encoder-decoder model sharded by
`launch.sharding.shard_tensor_parallel`, its ``tp_axis`` set, run under
``with mesh:``): the embedding and the head split the padded vocabulary
(`layers.vocab_parallel_embedding`; `train_loss` takes the
vocabulary-parallel cross-entropy, `layers.vocab_parallel_ce_terms`),
the blocks are Megatron's (`blocks.apply_block`), and `prefill` and
`decode_step` return the logits gathered over the vocabulary, so every
rank of a "model" line returns the same logits as one device. With
``sequence_parallel``, `train_loss` and `prefill` keep the residual
stream split along T over the axis where it divides T (the reference's
``residual_spec``); the positions are those of the whole sequence, which
the sublayers gather before they project q and k. An encoder's stream
splits along its own sequence in the same way; its memory reaches every
rank whole (gathered along the sequence where it was split), entering
the cross-attention's region once for every decoder layer, whose
``ln_cross`` runs on the rank's block of the decoder's stream.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.types import Device, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blocks_lib
from repro_torch.distributed import (active_mesh, all_gather, axis_index,
                                     axis_size, psum)
from repro_torch.models.layers import (cross_entropy_loss,
                                       cross_entropy_terms, dtype_of,
                                       embedding_lookup, init_embedding,
                                       init_linear, init_rms_norm, rms_norm,
                                       tp_axis, tp_enter, tp_weight,
                                       vocab_parallel_ce_terms,
                                       vocab_parallel_embedding)

#: ``cfg.remat`` values (`_layer_fn`).
REMATS = ("none", "block", "dots")


class CausalLM(nn.Module):
    """``embed [padded_vocab, d]``, ``runs`` (one ``nn.ModuleList`` of
    blocks per run of `layer_schedule`), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (an ``nn.Linear`` to the padded
    vocabulary). An encoder-decoder config also has the reference's
    ``encoder`` (an ``nn.ModuleList`` of ``encoder_layers`` dense blocks),
    ``enc_norm``, ``cross_attn`` (an ``nn.ModuleList`` of one `Attention`
    per decoder layer) and ``ln_cross [num_layers, d]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        self.embed = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype)
        self.runs = nn.ModuleList(
            nn.ModuleList(blocks_lib.init_block(cfg, run.kind, gen, dtype)
                          for _ in range(run.count))
            for run in blocks_lib.layer_schedule(cfg))
        self.final_norm = init_rms_norm(cfg.d_model, dtype, gen.device)
        self.lm_head = None if cfg.tie_embeddings else init_linear(
            gen, cfg.d_model, cfg.padded_vocab, dtype)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                blocks_lib.init_block(cfg, "dense", gen, dtype)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = init_rms_norm(cfg.d_model, dtype, gen.device)
            self.cross_attn = nn.ModuleList(
                attn_lib.init_attention(cfg, gen, dtype)
                for _ in range(cfg.num_layers))
            self.ln_cross = nn.Parameter(torch.ones(
                (cfg.num_layers, cfg.d_model), dtype=dtype,
                device=gen.device))


def init_model(cfg: ModelConfig, key: Union[int, torch.Generator] = 0, *,
               device: Device = None) -> CausalLM:
    """Random weights (normal, std 0.02; norms 1; biases 0) drawn from
    ``key``: a seed for a generator on ``device`` (the card unless
    ``device="cpu"``), or a ``torch.Generator``, whose device is used."""
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(key)
    with torch.no_grad():
        return CausalLM(cfg, gen)


def _positions(cfg: ModelConfig, B: int, T: int, offset=0,
               device=None) -> torch.Tensor:
    """Positions ``[B, T]`` (``[3, B, T]`` under M-RoPE, rows equal for
    text) starting at ``offset``, an int or a device tensor."""
    pos = offset + torch.arange(T, dtype=torch.int32, device=device)
    if cfg.rope_mode == "mrope":
        return pos.expand(3, B, T)
    return pos.expand(B, T)


def _apply_stack(model: CausalLM, x: torch.Tensor, cfg: ModelConfig,
                 runs, *, positions: torch.Tensor, caches=None,
                 causal: bool = True, memory: Optional[torch.Tensor] = None,
                 impl: str = "auto", remat: str = "none",
                 seq_split: bool = False):
    """Apply all runs, layer by layer. ``caches``: a list aligned with
    ``runs`` (or None). ``memory`` (encoder-decoder): the encoder output
    ``[B, S, d]``; after decoder layer ``gl``'s block, ``x`` gains
    ``cross_attn[gl]`` of ``rms_norm(x, ln_cross[gl])`` against it.
    ``remat`` (without caches): ``"block"`` or ``"dots"`` recompute each
    layer in the backward pass (`_layer_fn`). ``seq_split`` (without
    caches): a tensor-parallel model's residual stream is the rank's
    block of T. Returns (x, new_caches, aux_total): the MoE layers' aux
    losses summed (a float32 tensor; 0.0 without MoE)."""
    aux_total = 0.0
    new_caches: Optional[List] = [] if caches is not None else None
    for ri, run in enumerate(runs):
        rcache = caches[ri] if caches is not None else None
        attends = run.kind in blocks_lib.ATTENTION_KINDS
        lengths = []
        for li, block in enumerate(model.runs[ri]):
            if rcache is None:
                fn = _layer_fn(model, block, cfg, run, run.first_layer + li,
                               positions=positions, causal=causal,
                               memory=memory, impl=impl, remat=remat,
                               seq_split=seq_split)
                x, a = fn(x)
                aux_total = aux_total + a
                continue
            lc = blocks_lib.layer_cache(rcache, li)
            x, nc, a = blocks_lib.apply_block(
                block, x, cfg, run.kind, positions=positions,
                window=run.window, cache=lc, causal=causal, impl=impl)
            if memory is not None:
                x = _cross(model, x, memory, cfg, run.first_layer + li, impl)
            aux_total = aux_total + a
            if attends:
                lengths.append(nc["attn"].length)
        if new_caches is not None:
            # The layers wrote their slices of the run's buffers in place;
            # an attention run's lengths advance.
            if attends:
                c = rcache["attn"]
                rcache = dict(rcache, attn=attn_lib.KVCache(
                    c.k, c.v, torch.stack(lengths)))
            new_caches.append(rcache)
    return x, new_caches, aux_total


def _cross(model: CausalLM, x: torch.Tensor, memory: torch.Tensor,
           cfg: ModelConfig, gl: int, impl: str,
           seq_split: bool = False) -> torch.Tensor:
    ln = tp_weight(model.ln_cross, tp_axis(model), seq_split)
    h = rms_norm(x, ln[gl], cfg.rmsnorm_eps)
    return x + attn_lib.cross_attention_layer(
        model.cross_attn[gl], h, memory, cfg, impl=impl, seq_split=seq_split)


def _layer_fn(model: CausalLM, block, cfg: ModelConfig, run, gl: int, *,
              positions: torch.Tensor, causal: bool,
              memory: Optional[torch.Tensor], impl: str, remat: str,
              seq_split: bool = False):
    """One layer without a cache, ``x -> (x, aux)``: the block and, with
    ``memory``, decoder layer ``gl``'s cross-attention sublayer. Under
    ``remat`` ``"block"`` (the reference's ``jax.checkpoint`` of a scan
    body) the layer keeps only its input for the backward pass and runs
    again there (`torch.utils.checkpoint`, non-reentrant); ``"dots"`` (the
    reference saves the matmul outputs) is taken as ``"block"``. Either
    is memory only: the numbers are those of ``"none"``."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r}; one of {REMATS}")

    def fn(x):
        x, _, a = blocks_lib.apply_block(
            block, x, cfg, run.kind, positions=positions, window=run.window,
            causal=causal, impl=impl, seq_split=seq_split)
        if memory is not None:
            x = _cross(model, x, memory, cfg, gl, impl, seq_split)
        return x, a

    if remat == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _logits(model: CausalLM, cfg: ModelConfig, x: torch.Tensor,
            seq_split: bool = False) -> torch.Tensor:
    """The final norm and the head; under tensor parallelism the rank's
    block of the padded vocabulary (of the whole sequence)."""
    axis = tp_axis(model)
    x = rms_norm(x, tp_weight(model.final_norm, axis, seq_split),
                 cfg.rmsnorm_eps)
    if axis is not None:
        x = tp_enter(x, axis, seq_split)
    if cfg.tie_embeddings:
        return x @ model.embed.T
    return model.lm_head(x)


def _embed(model: CausalLM, cfg: ModelConfig, tokens: torch.Tensor,
           seq_split: bool = False) -> torch.Tensor:
    """The embedding of ``tokens`` in the compute dtype: under tensor
    parallelism from the rank's block of the vocabulary, the rank's block
    of T where ``seq_split``."""
    axis = tp_axis(model)
    if axis is None:
        x = embedding_lookup(model.embed, tokens)
    else:
        x = vocab_parallel_embedding(model.embed, tokens, axis, seq_split)
    return x.to(dtype_of(cfg.compute_dtype))


def _seq_split(model: CausalLM, T: int, sequence_parallel: bool) -> bool:
    """Whether a tensor-parallel model's residual stream splits along T:
    asked for, and T divides over the axis (the reference's rule)."""
    axis = tp_axis(model)
    return bool(sequence_parallel and axis is not None
                and T % axis_size(axis) == 0)


def _gathered(model: CausalLM, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole padded vocabulary: a tensor-parallel model's
    blocks gathered over its axis."""
    axis = tp_axis(model)
    return logits if axis is None else all_gather(logits, axis, axis=-1,
                                                  tiled=True)


def init_caches(cfg: ModelConfig, B: int, S: int, *,
                device: Device = None) -> list:
    """Empty decode caches of capacity ``S`` for a batch of ``B``, in the
    compute dtype, on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    return [blocks_lib.init_run_cache(cfg, run, B, S, dtype, device)
            for run in blocks_lib.layer_schedule(cfg)]


def cache_specs(cfg: ModelConfig, batch_spec=("data",)) -> list:
    """The decode caches' layout on a mesh, aligned with `init_caches`:
    one `blocks.run_cache_spec` per run."""
    return [blocks_lib.run_cache_spec(cfg, run, batch_spec)
            for run in blocks_lib.layer_schedule(cfg)]


def _encode(model: CausalLM, cfg: ModelConfig, enc_emb: torch.Tensor, *,
            impl: str = "auto", remat: str = "none",
            sequence_parallel: bool = False) -> torch.Tensor:
    B, S, _ = enc_emb.shape
    x = enc_emb.to(dtype_of(cfg.compute_dtype))
    positions = _positions(cfg, B, S, device=enc_emb.device)
    run = blocks_lib.Run(kind="dense", count=cfg.encoder_layers, window=0,
                         first_layer=0)
    axis = tp_axis(model)
    sp = _seq_split(model, S, sequence_parallel)
    if sp:
        Sb = S // axis_size(axis)
        x = x.narrow(1, axis_index(axis) * Sb, Sb)
    for block in model.encoder:
        x, _ = _layer_fn(model, block, cfg, run, 0, positions=positions,
                         causal=False, memory=None, impl=impl,
                         remat=remat, seq_split=sp)(x)
    x = rms_norm(x, tp_weight(model.enc_norm, axis, sp), cfg.rmsnorm_eps)
    # The memory, whole on every rank of the axis, enters the
    # cross-attention's region here, once for every decoder layer.
    return x if axis is None else tp_enter(x, axis, sp)


@torch.no_grad()
def encode(model: CausalLM, cfg: ModelConfig, enc_emb: torch.Tensor, *,
           impl: str = "auto", sequence_parallel: bool = False
           ) -> torch.Tensor:
    """The encoder memory ``[B, S, d]`` (compute dtype) of the stub
    frontend's embeddings ``enc_emb [B, S, d]``: the dense encoder blocks
    with RoPE positions and non-causal self-attention, then ``enc_norm``.
    Builds no graph (`train_loss` runs the same encoder with one). A
    tensor-parallel model (module docstring) splits the encoder's stream
    along S where ``sequence_parallel`` asks and S divides; the memory is
    whole on every rank either way."""
    return _encode(model, cfg, enc_emb, impl=impl,
                   sequence_parallel=sequence_parallel)


def train_loss(model: CausalLM, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], *,
               sequence_parallel: bool = False
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of ``batch`` (``tokens``, ``labels [B, T]`` and,
    for an encoder-decoder, ``enc_emb [B, S, d]``) under autograd: the
    forward over the whole sequence, causal, then `cross_entropy_loss`
    over the padded vocabulary with ``cfg.z_loss``. Returns (loss, ``{"ce",
    "aux"}``), ``loss = ce + router_aux_coef * aux`` with ``aux`` the MoE
    layers' load-balance losses summed (0 elsewhere), float32 scalars.

    Everything runs the plain versions (``impl="plain"``) on the model's
    device, as the reference's training path reaches no Pallas kernel;
    the CUDA kernels have no backward and refuse inputs that need one.
    ``cfg.remat`` recomputes each layer in the backward pass
    (`_layer_fn`).

    Under ``with mesh:`` on a rank of a mesh, ``batch`` holds the rank's
    rows of the global batch (split over the batch axes, "pod" and
    "data"), the mixers take their expert- and sequence-parallel paths,
    and ``ce`` is the mean over the global batch: the sums of the ranks'
    token losses and counts, each summed over the batch axes. A
    tensor-parallel model (module docstring) runs its rank's blocks, with
    the residual stream split along T where ``sequence_parallel`` asks
    for it and T divides."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, T = tokens.shape
    memory = None
    if cfg.encoder_layers:
        memory = _encode(model, cfg, batch["enc_emb"], impl="plain",
                         remat=cfg.remat, sequence_parallel=sequence_parallel)
    sp = _seq_split(model, T, sequence_parallel)
    x = _embed(model, cfg, tokens, sp)
    positions = _positions(cfg, B, T, device=tokens.device)
    x, _, aux = _apply_stack(model, x, cfg, blocks_lib.layer_schedule(cfg),
                             positions=positions, memory=memory,
                             impl="plain", remat=cfg.remat, seq_split=sp)
    logits = _logits(model, cfg, x, sp)
    mesh = active_mesh()
    batch_axes = tuple(a for a in ("pod", "data") if mesh is not None
                       and mesh.shape.get(a, 1) > 1)
    axis = tp_axis(model)
    if axis is not None:
        # The rank's block of the vocabulary: the loss's terms summed over
        # the axis, then over the batch axes.
        total, count = vocab_parallel_ce_terms(
            logits, labels, cfg.vocab_size, axis, z_loss=cfg.z_loss)
        if batch_axes:
            total, count = psum(total, batch_axes), psum(count, batch_axes)
        ce = total / count.clamp_min(1)
    elif batch_axes:
        # The rank's rows: the mean over the global batch is the ratio of
        # the sums over the batch axes (psum's transpose: the identity).
        total, count = cross_entropy_terms(logits, labels, cfg.vocab_size,
                                           z_loss=cfg.z_loss)
        ce = psum(total, batch_axes) / psum(count, batch_axes).clamp_min(1)
    else:
        ce = cross_entropy_loss(logits, labels, cfg.vocab_size,
                                z_loss=cfg.z_loss)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: CausalLM, cfg: ModelConfig, tokens: torch.Tensor,
            enc_emb: Optional[torch.Tensor] = None, *,
            impl: str = "auto", sequence_parallel: bool = False
            ) -> torch.Tensor:
    """Forward over the prompt ``tokens [B, T]``; returns the last
    position's logits ``[B, 1, padded_vocab]``. An encoder-decoder config
    encodes ``enc_emb [B, S, d]`` first and attends to its memory. As in
    the reference it builds no cache (the service teacher-forces the
    prompt through `decode_step`). A tensor-parallel model (module
    docstring) splits the residual stream along T where
    ``sequence_parallel`` asks and T divides."""
    B, T = tokens.shape
    memory = None
    if cfg.encoder_layers:
        if enc_emb is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill needs "
                             "the frontend embeddings (enc_emb=)")
        memory = encode(model, cfg, enc_emb, impl=impl,
                        sequence_parallel=sequence_parallel)
    sp = _seq_split(model, T, sequence_parallel)
    x = _embed(model, cfg, tokens, sp)
    positions = _positions(cfg, B, T, device=tokens.device)
    x, _, _ = _apply_stack(model, x, cfg, blocks_lib.layer_schedule(cfg),
                           positions=positions, memory=memory, impl=impl,
                           seq_split=sp)
    last = x[:, -1:, :]
    if sp:
        # The last position is the last rank's: summed with the others'
        # zeros, every rank holds it.
        axis = tp_axis(model)
        if axis_index(axis) != axis_size(axis) - 1:
            last = torch.zeros_like(last)
        last = psum(last, axis)
    return _gathered(model, _logits(model, cfg, last))


@torch.no_grad()
def decode_step(model: CausalLM, cfg: ModelConfig, caches: list,
                tokens: torch.Tensor, pos,
                memory: Optional[torch.Tensor] = None, *,
                impl: str = "auto"):
    """One decode step: ``tokens [B, 1]`` at absolute position ``pos`` (an
    int or a device int tensor); an encoder-decoder config attends to the
    encoder ``memory [B, S, d]`` (`encode`), which it needs. Returns
    (logits ``[B, 1, padded_vocab]``, caches), the caches written in
    place."""
    if cfg.encoder_layers and memory is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder decode step needs "
                         "the encoder memory (memory=encode(...))")
    B = tokens.shape[0]
    x = _embed(model, cfg, tokens)
    positions = _positions(cfg, B, 1, offset=pos, device=tokens.device)
    x, new_caches, _ = _apply_stack(model, x, cfg,
                                    blocks_lib.layer_schedule(cfg),
                                    positions=positions, caches=caches,
                                    memory=memory if cfg.encoder_layers
                                    else None, impl=impl)
    return _gathered(model, _logits(model, cfg, x)), new_caches
