"""Mixture-of-Experts layer (PyTorch): top-k routing with the reference's
sort-based capacity dispatch, shared experts (DeepSeek-MoE) and the
auxiliary load-balancing loss. The JAX package's ``repro.models.moe``
global path (``_moe_layer_global``); its expert-parallel path needs a
mesh and waits for the cross-device slice (ROADMAP queue A).

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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.layers import normal_init, silu


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


def route(params: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """The routing and dispatch of ``xt [n, d]``, as the reference's.
    Returns a dict: ``experts [n, k]`` (top-k, highest first), ``aux``
    (float32 scalar), ``C``, and per assignment in expert order ``tok``,
    ``gate_sorted`` (the renormalised float32 gate), ``keep`` and ``slot``
    (``E * C`` for a dropped one)."""
    n = xt.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = xt.device
    # The router's product in the parameter dtype, then float32.
    probs = torch.softmax((xt @ params.router).float(), dim=-1)   # [n, E]
    # Ties in the probabilities are improbable in float32; torch.topk's
    # order among them is unspecified (lax.top_k takes the lower index).
    gate, experts = torch.topk(probs, k, dim=-1)                  # [n, k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # Aux loss (Switch-style): mean prob mass vs. token fraction per expert.
    first = (experts[:, :1] == torch.arange(E, device=dev)).float()
    aux = E * torch.sum(probs.mean(dim=0) * first.mean(dim=0))

    C = _capacity(n, cfg)
    flat_e = experts.reshape(-1)                                  # [n k]
    e_sorted, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts                            # exclusive
    rank = torch.arange(n * k, device=dev) - starts[e_sorted]
    keep = rank < C
    slot = torch.where(keep, e_sorted * C + rank, E * C)
    # Token-major layout: assignment i belongs to token i // k.
    return {"experts": experts, "aux": aux, "C": C, "tok": order // k,
            "gate_sorted": gate.reshape(-1)[order], "keep": keep,
            "slot": slot}


def moe_layer(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, T, d]`` -> (out ``[B, T, d]`` in x's dtype, aux load-balance
    loss, a float32 scalar tensor). The reference's global dispatch."""
    B, T, d = x.shape
    E = cfg.num_experts
    xt = x.reshape(B * T, d)
    r = route(params, xt, cfg)
    C, keep, slot, tok = r["C"], r["keep"], r["slot"], r["tok"]

    buf = x.new_zeros((E * C + 1, d))
    buf.index_copy_(0, slot, xt[tok])     # dropped ones land in the last row
    buf = buf[:-1].reshape(E, C, d)

    h = silu(torch.bmm(buf, params.w_gate)) * torch.bmm(buf, params.w_up)
    y = torch.bmm(h, params.w_down).reshape(E * C, d)

    gathered = y[torch.where(keep, slot, 0)]
    gathered = torch.where(keep[:, None], gathered, gathered.new_zeros(()))
    out = torch.zeros((B * T, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok, gathered.float() * r["gate_sorted"][:, None])
    out = out.to(x.dtype)
    if params.shared is not None:
        out = out + mlp_lib.mlp(params.shared, xt)
    return out.reshape(B, T, d), r["aux"]


def dropped(routing: dict) -> torch.Tensor:
    """Assignments over capacity in a `route` result (a device tensor)."""
    return (~routing["keep"]).sum()
