"""Mixture-of-Experts layer (PyTorch): top-k routing with the reference's
sort-based capacity dispatch, shared experts (DeepSeek-MoE) and the
auxiliary load-balancing loss. The JAX package's ``repro.models.moe``:
its global dispatch (``_moe_layer_global``: `moe_layer` on one device,
and on a mesh where the experts do not shard over "model") and its
expert-parallel dispatch (`_moe_layer_ep`, under a mesh).

The dispatch has static shapes: each of the ``n * k`` assignments (token
``t``, its ``j``-th expert ``e``) is laid out token-major, sorted by
expert with a stable sort, and takes rank ``r`` among its expert's
assignments; ``r < C`` (the capacity, `_capacity`) puts it in slot ``e C
+ r`` of an ``[E, C, d]`` buffer, and the rest are dropped (written to an
overflow row that is cut off). The experts' SwiGLU products run batched
over E on the whole buffer (``torch.bmm``: the reference leaves them to
XLA, outside any kernel), and each kept assignment's output, weighed by
its renormalised gate, is summed back into its token in float32.

`moe_layer` makes no host sync (no ``bincount``, ``nonzero``, boolean-mask
indexing or ``.item()``; the counts per expert are a ``scatter_add_``),
so a decode step that runs it never waits on the device.

Expert parallelism (`_moe_layer_ep`): under ``with mesh:`` on a rank of a
mesh whose "model" axis has ``tp > 1`` ranks, with ``E`` and ``T``
multiples of ``tp``, each rank routes its ``T / tp`` slice of the tokens
locally (capacity ``_capacity(n_local)`` per expert and slice), sends each
expert's slots to the rank that owns the expert (``E / tp`` experts per
rank, one ``all_to_all``), runs its experts on what every rank sent, and
sends the outputs back (a second ``all_to_all``); each token then reads
its ``k`` outputs by inverting the sort (a gather, no ``index_add_``). The
shared experts run on the rank's column shard of ``w_gate``/``w_up`` and
row shard of ``w_down`` over the whole T (every rank holds it: the
activations are replicated over "model"), summed back to the slice in
float32 by ``psum_scatter``, and an ``all_gather`` along T returns
``[B_local, T, d]`` on every rank, as the reference's ``shard_map``
``out_specs`` do. The expert-parallel dispatch needs the rank's shards
(`shard_model`, `convert.lm_params(mesh=)`), the global dispatch every
expert. Decode (``T = 1``), a "model" axis of one rank and an expert
count or a T that ``tp`` does not divide (grok) take the global dispatch.

The global dispatch on a mesh whose batch axes ("pod", "data") have
several ranks routes the global batch, as the reference's GSPMD does:
each rank holds its rows, and `route` makes the capacity that of the
global token count, ranks each assignment among its expert's
assignments of the global batch (one all_gather of the ``[E]`` counts
per batch axis) and takes the aux loss's means over the global batch
(psums of the ranks' sums, whose transpose sends each rank the gradient
of its own rows only). A rank then dispatches and combines its own rows:
every expert runs on every rank, on the rows the rank keeps.

Under autograd the expert-parallel dispatch trains: the rank's expert
shards are parameters, the collectives have their transposes
(`repro_torch.distributed`), and ``x`` and the router, replicated over
"model" but used by each rank on its own slice, enter through `pvary`,
so their cotangents are summed over "model". The aux loss is the
reference's: the ``pmean`` over every axis of the mesh of each slice's
two halves.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import (all_gather, all_to_all, axis_index,
                                     axis_size, pmean, psum, psum_scatter,
                                     pvary)
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.layers import _active_mesh, normal_init, silu


class MoE(nn.Module):
    """``router [d, E]``; the experts stacked as in the reference,
    ``w_gate``/``w_up [E, d, dff]`` and ``w_down [E, dff, d]`` (not
    transposed); ``shared``, an `mlp.MLP` of width ``dff *
    num_shared_experts``, where the config has shared experts."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 dtype: torch.dtype):
        super().__init__()
        d, dff, E = cfg.d_model, cfg.d_ff_per_expert, cfg.num_experts
        self.router = nn.Parameter(normal_init(gen, (d, E), dtype))
        self.w_gate = nn.Parameter(normal_init(gen, (E, d, dff), dtype))
        self.w_up = nn.Parameter(normal_init(gen, (E, d, dff), dtype))
        self.w_down = nn.Parameter(normal_init(gen, (E, dff, d), dtype))
        self.shared: Optional[mlp_lib.MLP] = None
        if cfg.num_shared_experts:
            self.shared = mlp_lib.init_mlp(
                gen, d, dff * cfg.num_shared_experts, dtype)


def init_moe(cfg: ModelConfig, gen: torch.Generator,
             dtype: torch.dtype) -> MoE:
    return MoE(cfg, gen, dtype)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: ``n k / E`` times the
    capacity factor, plus one, rounded up to a multiple of 4 (at least
    4). A Python int, from shapes alone."""
    per = n_tokens * cfg.num_experts_per_tok / cfg.num_experts
    cap = int(per * cfg.capacity_factor) + 1
    return max(4, ((cap + 3) // 4) * 4)


def shard_experts(params: MoE, cfg: ModelConfig, rank: int, tp: int
                  ) -> None:
    """Keep, in place, only what expert-parallel rank ``rank`` of ``tp``
    holds: experts ``rank * E / tp ...`` of the stacked weights, and the
    shared experts' column shard of ``w_gate``/``w_up`` and row shard of
    ``w_down`` (the reference's ``P(None, "model")`` / ``P("model",
    None)``), as parameters that train. The router stays whole."""
    E = cfg.num_experts
    if E % tp:
        raise ValueError(f"{E} experts do not shard over {tp} ranks")
    El = E // tp
    for name in ("w_gate", "w_up", "w_down"):
        w = getattr(params, name)
        setattr(params, name, torch.nn.Parameter(
            w[rank * El:(rank + 1) * El].detach().clone()))
    if params.shared is not None:
        for name, dim in (("w_gate", 0), ("w_up", 0), ("w_down", 1)):
            lin = getattr(params.shared, name)
            part = lin.weight.shape[dim] // tp
            lin.weight = torch.nn.Parameter(
                lin.weight.narrow(dim, rank * part, part).detach().clone())
            lin.in_features, lin.out_features = (lin.weight.shape[1],
                                                 lin.weight.shape[0])


def shard_model(model: nn.Module, cfg: ModelConfig, mesh) -> None:
    """`shard_experts` on every MoE layer of ``model`` for this rank of
    ``mesh``'s "model" axis (nothing where that axis has one rank or does
    not divide the experts: those take the global dispatch)."""
    tp = mesh.shape.get("model", 1)
    if tp == 1 or cfg.num_experts % tp:
        return
    for m in model.modules():
        if isinstance(m, MoE):
            shard_experts(m, cfg, mesh.coords["model"], tp)


#: The axes over which a step says its rows are split (`rows_split_over`),
#: innermost last.
_ROW_AXES: List[tuple] = []


@contextlib.contextmanager
def rows_split_over(axes: tuple):
    """Within the block, the global dispatch takes a rank's rows to be its
    block of a global batch split over ``axes`` (of the ambient mesh):
    ``()`` where every rank holds the whole batch, as a decode step's
    rows where the batch does not divide "data". Outside any such block
    the rows are split over every batch axis ("pod", "data")."""
    _ROW_AXES.append(tuple(axes))
    try:
        yield
    finally:
        _ROW_AXES.pop()


def _batch_axes(mesh) -> tuple:
    """The batch axes that a rank's rows are split over (`rows_split_over`;
    by default "pod" and "data") and that have more than one rank of
    ``mesh`` (none without a mesh)."""
    if mesh is None:
        return ()
    axes = _ROW_AXES[-1] if _ROW_AXES else ("pod", "data")
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def _rows_before(counts: torch.Tensor, batch: tuple) -> torch.Tensor:
    """Per expert, the assignments of the ranks whose rows come before
    this rank's in the global batch (rows split row-major over the
    ``batch`` axes): the sum of their ``counts`` (an all_gather over
    each axis)."""
    mesh = _active_mesh()
    every = counts
    for a in reversed(batch):
        every = all_gather(every, a)
    every = every.reshape(-1, counts.shape[-1])
    index = 0
    for a in batch:
        index = index * mesh.shape[a] + mesh.coords[a]
    return every[:index].sum(dim=0)


def _route_parts(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
                 batch: tuple = ()):
    """`route` from the router matrix, with the aux loss's two halves
    ``me`` (mean probability per expert) and ``ce`` (share of tokens
    whose first choice it is) in place of ``aux``. ``batch``: the mesh's
    batch axes over which ``xt`` is the rank's rows of a global batch,
    whose routing this is (`route`)."""
    n = xt.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = xt.device
    # The router's product in the parameter dtype, then float32.
    probs = torch.softmax((xt @ router).float(), dim=-1)          # [n, E]
    # Ties in the probabilities are improbable in float32; torch.topk's
    # order among them is unspecified (lax.top_k takes the lower index).
    gate, experts = torch.topk(probs, k, dim=-1)                  # [n, k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # Aux loss (Switch-style): mean prob mass vs. token fraction per expert.
    first = (experts[:, :1] == torch.arange(E, device=dev)).float()
    n_all = n
    if batch:
        # The global batch's means: the ranks' sums summed (psum's
        # transpose is the identity, so a rank's gradient flows through
        # its own rows only, and the batch axes' sum of the ranks'
        # gradients is the global one).
        n_all = n * axis_size(batch)
        me = psum(probs.sum(dim=0), batch) / n_all
        ce = psum(first.sum(dim=0), batch) / n_all
    else:
        me, ce = probs.mean(dim=0), first.mean(dim=0)

    C = _capacity(n_all, cfg)
    flat_e = experts.reshape(-1)                                  # [n k]
    e_sorted, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts                            # exclusive
    rank = torch.arange(n * k, device=dev) - starts[e_sorted]
    if batch:
        # Kept by its rank among the expert's assignments of the global
        # batch, laid out token-major (the earlier ranks' rows first);
        # placed by its rank among the rank's own, in a buffer of
        # min(C, n) slots per expert (a token takes an expert once, so no
        # expert gets more than n of the rank's assignments).
        keep = rank + _rows_before(counts, batch)[e_sorted] < C
        C = min(C, n)
    else:
        keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank, E * C)
    # Token-major layout: assignment i belongs to token i // k.
    return {"experts": experts, "me": me, "ce": ce, "C": C,
            "tok": order // k, "gate_sorted": gate.reshape(-1)[order],
            "keep": keep, "slot": slot}


def route(params: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """The routing and dispatch of ``xt [n, d]``, as the reference's.
    Returns a dict: ``experts [n, k]`` (top-k, highest first), ``aux``
    (float32 scalar), ``C`` (the slots per expert of the dispatch
    buffer: the capacity), and per assignment in expert order ``tok``,
    ``gate_sorted`` (the renormalised float32 gate), ``keep`` and ``slot``
    (``E * C`` for a dropped one).

    Under a mesh whose batch axes ("pod", "data", or those that
    `rows_split_over` names) have more than one rank, ``xt`` is the
    rank's rows of the global batch (rows split over those axes,
    row-major) and the routing is the global batch's, as the
    reference's GSPMD computes it: the capacity ``C`` of the global token
    count, an assignment kept by its rank among its expert's assignments
    of the global batch (the counts of the ranks before this one, one
    all_gather of ``[E]`` integers), and ``aux`` of the global means (a
    psum of the ranks' sums). The rank dispatches only its own kept
    assignments, into ``C = min(capacity, n)`` slots per expert; an
    expert's output per row is the same in any slot, so the rank's rows
    get the global dispatch's outputs."""
    r = _route_parts(params.router, xt, cfg, _batch_axes(_active_mesh()))
    r["aux"] = cfg.num_experts * torch.sum(r.pop("me") * r.pop("ce"))
    return r


def _route_local(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Routing and capacity buckets of a rank's token slice ``xt [n,
    d]``: ``(buf [E, C, d], routing, (me, ce))``, ``routing`` as
    `route`'s without ``aux`` (the reference's combine metadata and
    more)."""
    r = _route_parts(router, xt, cfg)
    return _dispatch(xt, r, cfg.num_experts), r, (r.pop("me"), r.pop("ce"))


def _dispatch(xt: torch.Tensor, r: dict, E: int) -> torch.Tensor:
    """The ``[E, C, d]`` capacity buckets of ``xt [n, d]`` (`route`)."""
    C, d = r["C"], xt.shape[-1]
    buf = xt.new_zeros((E * C + 1, d))
    # Dropped ones land in the last row, cut off.
    buf.index_copy_(0, r["slot"], xt[r["tok"]])
    return buf[:-1].reshape(E, C, d)


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buckets ``[E, C, d]``, batched over E."""
    h = silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _combine_gather(y: torch.Tensor, r: dict, n: int, k: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Each of ``n`` tokens' ``k`` expert outputs ``y [E, C, d]`` weighed
    by its gates and summed in float32, read by inverting the sort: per
    token its assignments in expert order (the reference's order), a
    dropped one reading a zero row. ``[n, d]`` in ``dtype``."""
    E, C, d = y.shape
    y_flat = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
    inv = torch.argsort(r["tok"] * (n * k)
                        + torch.arange(n * k, device=y.device))
    slot = torch.where(r["keep"], r["slot"], E * C)[inv].reshape(n, k)
    gate = r["gate_sorted"][inv].reshape(n, k)
    picked = y_flat[slot].float()                             # [n, k, d]
    return torch.einsum("nk,nkd->nd", gate, picked).to(dtype)


def moe_layer(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, T, d]`` -> (out ``[B, T, d]`` in x's dtype, aux load-balance
    loss, a float32 scalar tensor). Under a mesh with "model" ranks that
    divide E and T, the expert-parallel dispatch (`_moe_layer_ep`); else
    the reference's global dispatch, which needs every expert."""
    mesh = _active_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        tp = mesh.shape["model"]
        if tp > 1 and cfg.num_experts % tp == 0 and x.shape[1] % tp == 0:
            return _moe_layer_ep(params, x, cfg, mesh)
    B, T, d = x.shape
    E = cfg.num_experts
    if params.w_gate.shape[0] != E:
        raise ValueError(
            f"moe_layer: this rank holds {params.w_gate.shape[0]} of {E} "
            f"experts; the global dispatch (T = {T} here) needs them all")
    xt = x.reshape(B * T, d)
    r = route(params, xt, cfg)
    C, keep, slot, tok = r["C"], r["keep"], r["slot"], r["tok"]

    buf = _dispatch(xt, r, E)
    y = _experts(buf, params.w_gate, params.w_up,
                 params.w_down).reshape(E * C, d)

    gathered = y[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered, gathered.new_zeros(()))
    out = torch.zeros((B * T, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, gathered.float() * r["gate_sorted"][:, None])
    out = out.to(x.dtype)
    if params.shared is not None:
        out = out + mlp_lib.mlp(params.shared, xt)
    return out.reshape(B, T, d), r["aux"]


def _moe_layer_ep(params: MoE, x: torch.Tensor, cfg: ModelConfig, mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch on this rank of ``mesh`` (module
    docstring): ``x [B_local, T, d]``, replicated over "model", ->
    (``[B_local, T, d]`` on every rank of "model", the aux loss averaged
    over every axis of the mesh). ``params`` holds the rank's shards
    (`shard_model`)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    tp, rank = mesh.shape["model"], axis_index("model")
    El = E // tp
    dsh = cfg.d_ff_per_expert * cfg.num_shared_experts
    if params.w_gate.shape[0] != El or (
            params.shared is not None
            and params.shared.w_gate.weight.shape[0] != dsh // tp):
        raise ValueError(
            f"moe_layer: the expert-parallel dispatch over {tp} ranks needs "
            f"this rank's {El} of {E} experts and its 1/{tp} of the shared "
            f"experts; it holds {params.w_gate.shape[0]} experts (shard the "
            "model first: moe.shard_model or convert.lm_params(mesh=))")
    B, T, d = x.shape
    Tl = T // tp
    # Replicated over "model", used by each rank in its own way: their
    # cotangents are summed over "model" (pvary's backward).
    x = pvary(x, "model")
    router = pvary(params.router, "model")
    xt = x[:, rank * Tl:(rank + 1) * Tl].reshape(B * Tl, d)
    n = xt.shape[0]
    buf, r, (me, ce) = _route_local(xt, router, cfg)
    axes = mesh.axis_names
    aux = E * torch.sum(pmean(me, axes) * pmean(ce, axes))
    C = r["C"]

    # To the experts' owners: [E, C, d] as [tp, El, C, d]; block p goes to
    # rank p, and block p received holds rank p's slots for my El experts.
    recv = all_to_all(buf.reshape(tp, El, C, d), "model", 0, 0, tiled=True)
    toks = recv.transpose(0, 1).reshape(El, tp * C, d)
    y = _experts(toks, params.w_gate, params.w_up,
                 params.w_down)                             # [El, tp C, d]
    back = y.reshape(El, tp, C, d).transpose(0, 1)
    mine = all_to_all(back, "model", 0, 0, tiled=True)      # [tp, El, C, d]
    out = _combine_gather(mine.reshape(E, C, d), r, n, k, x.dtype)

    if params.shared is not None:
        # The whole T's tokens through the rank's shard of the shared
        # experts' hidden width, summed back to the rank's slice. xg holds
        # every rank's slice in the layout of xt, rank after rank.
        sg, su, sd = (lin.weight for lin in (
            params.shared.w_gate, params.shared.w_up, params.shared.w_down))
        xg = x.reshape(B, tp, Tl, d).transpose(0, 1).reshape(-1, d)
        # The partial products over the hidden shards are summed in
        # float32 and rounded once, as the one product of the global
        # dispatch is (the reference sums them in the compute dtype).
        part = (silu(xg @ sg.T) * (xg @ su.T)).float() @ sd.T.float()
        out = out + psum_scatter(part, "model", scatter_dimension=0,
                                 tiled=True).to(x.dtype)
    out = all_gather(out.reshape(B, Tl, d), "model", axis=1, tiled=True)
    return out, aux


def dropped(routing: dict) -> torch.Tensor:
    """Assignments over capacity in a `route` result (a device tensor)."""
    return (~routing["keep"]).sum()
