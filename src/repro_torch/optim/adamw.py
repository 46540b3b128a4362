"""AdamW with decoupled weight decay, global-norm clipping and ZeRO-1
sharded moments: the JAX package's ``repro.optim.adamw``.

Parameters, gradients and moments are dicts keyed by parameter name (a
model's ``named_parameters()``). The moments are float32 whatever the
parameter dtype, and there is no master copy: a bfloat16 parameter is
updated in float32 and rounded back, as the reference does. The update
runs as multi-tensor ``torch._foreach_*`` ops, in place (the reference
returns new arrays), with the step count and the schedule's scale kept
on the parameters' device, so it never waits on the host.

Weight decay skips what the reference's ``_decay_mask`` skips, decided
on the reference's path of each parameter (`convert.jax_path`), not on
the port's name: ``attn.wq.bias`` is the reference's ``attn/bq``, which
it decays.

On a mesh (`adamw_update_sharded`), `zero_specs` lays the moments out:
each parameter's spec with "data" added on its largest divisible
unsharded dimension (ZeRO-1: the parameters keep their layout, the
float32 state spreads over the whole mesh). Each rank updates its block
of the moments and the matching part of its parameter block, then
all_gathers the parts over "data" to re-form the block. The global norm
counts every element once: the squares of a block replicated over an
axis are not summed over that axis, so the clip scale is the one-device
scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, NamedTuple, Tuple

import torch

from repro_torch import convert
from repro_torch.distributed import (P, NamedSharding, coarsen_block,
                                     map_specs, psum, refine_block,
                                     spec_axes, widen_spec)


class AdamWState(NamedTuple):
    step: torch.Tensor               # [] int32
    m: Dict[str, torch.Tensor]       # float32, like the parameters
    v: Dict[str, torch.Tensor]       # float32, like the parameters


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_adamw(params) -> AdamWState:
    """Zero moments in float32 for ``params`` (a dict of tensors or a
    module), on their devices; step 0."""
    params = _named(params)
    dev = next(iter(params.values())).device
    zeros = lambda: {n: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                    device=p.device)
                     for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def _decay_mask(path: str) -> bool:
    """No weight decay on norms/biases/scalars (the reference's rule, on
    the reference's path)."""
    return not any(t in path for t in ("norm", "ln", "bias", "b_",
                                       "dt_bias", "A_log", "D"))


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """Per parameter name of a port LM, whether AdamW decays it: the
    reference's ``_decay_mask`` on its path (`convert.jax_path`)."""
    return {n: _decay_mask(convert.jax_path(n)) for n in names}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, in float32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _moments_step(cfg: AdamWConfig, names, ps, ms, vs, g32, gnorm,
                  step_in: torch.Tensor, lr_scale):
    """The AdamW update of ``ps`` (updated in place, in their dtype) and
    the float32 moments ``ms``, ``vs`` from the float32 gradients ``g32``
    (consumed) with global norm ``gnorm``. Returns (step + 1, clip
    scale)."""
    decay = decay_mask(names)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = step_in + 1
    stepf = step.float()
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=stepf.device)

    torch._foreach_mul_(g32, scale)
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, g32, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_addcmul_(vs, g32, g32, value=1.0 - cfg.b2)
    g32.clear()
    denom = torch._foreach_div(vs, b2c)          # vhat
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    delta = torch._foreach_div(ms, b1c)          # mhat
    torch._foreach_div_(delta, denom)
    del denom
    p32 = [p.to(torch.float32, copy=True) for p in ps]
    if cfg.weight_decay:
        dec = [i for i, n in enumerate(names) if decay[n]]
        if dec:
            torch._foreach_add_([delta[i] for i in dec],
                                [p32[i] for i in dec],
                                alpha=cfg.weight_decay)
    torch._foreach_mul_(delta, lr)
    torch._foreach_sub_(p32, delta)
    del delta
    torch._foreach_copy_(ps, p32)
    return step, scale


def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState,
                 lr_scale=1.0
                 ) -> Tuple[Mapping[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step on ``params`` with ``grads`` (same names), the
    learning rate ``cfg.lr * lr_scale`` (a float or a device scalar).
    Gradients are clipped to global norm ``cfg.clip_norm``; the names
    `decay_mask` marks are decayed. ``params`` and the state's moments
    are updated in place; returns (``params``, the state with ``step +
    1``, ``{"grad_norm", "clip_scale"}``)."""
    names = list(params)
    with torch.no_grad():
        g32 = [grads[n].to(torch.float32, copy=True) for n in names]
        gnorm = global_norm(g32)
        step, scale = _moments_step(
            cfg, names, [params[n] for n in names],
            [state.m[n] for n in names], [state.v[n] for n in names], g32,
            gnorm, state.step, lr_scale)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "clip_scale": scale}


def zero_specs(param_specs, mesh_axis_sizes: dict, shapes) -> AdamWState:
    """Moment specs: each parameter's spec with "data" on its largest
    divisible unsharded dim (ZeRO-1). ``param_specs`` and ``shapes`` (of
    sizes, or of anything with a ``.shape``) nest alike (a dict by name,
    or the reference's pytree)."""
    dsize = mesh_axis_sizes.get("data", 1)
    widened = map_specs(lambda sp, shp: widen_spec(sp, shp, dsize,
                                                   least=-1),
                        param_specs, shapes)
    return AdamWState(step=P(), m=widened,
                      v=map_specs(lambda sp: sp, widened))


def sharded_global_norm(grads: Mapping[str, torch.Tensor],
                        shardings: Mapping[str, NamedSharding]
                        ) -> torch.Tensor:
    """The global L2 norm of gradients held as blocks (``grads[n]`` under
    ``shardings[n]``), every element counted once: each block's squares
    are summed over the axes its spec shards, and over no other."""
    groups: Dict[tuple, list] = {}
    for n, g in grads.items():
        sh = shardings[n]
        axes = tuple(a for a in spec_axes(sh.spec) if sh.mesh.shape[a] > 1)
        groups.setdefault(axes, []).append(g)
    total = None
    for axes, gs in groups.items():
        sq = torch.stack(torch._foreach_norm(
            [g.float() for g in gs])).square().sum()
        if axes:
            sq = psum(sq, axes)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update_sharded(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                         grads: Mapping[str, torch.Tensor],
                         state: AdamWState, lr_scale=1.0, *,
                         param_shardings: Mapping[str, NamedSharding],
                         moment_shardings: Mapping[str, NamedSharding]
                         ) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                                    dict]:
    """One AdamW step on a mesh (ZeRO-1; module docstring), inside ``with
    mesh:`` on every rank. ``params[n]``: the rank's block under
    ``param_shardings[n]``, updated in place; ``grads[n]`` (float32, the
    whole gradient's block: summed over the batch axes), ``state.m[n]``
    and ``state.v[n]``: the rank's blocks under ``moment_shardings[n]``
    (`zero_specs`). Returns what `adamw_update` returns, the metrics equal
    on every rank."""
    names = list(params)
    with torch.no_grad():
        gnorm = sharded_global_norm({n: grads[n] for n in names},
                                    moment_shardings)
        parts = [refine_block(params[n], param_shardings[n],
                              moment_shardings[n]) for n in names]
        g32 = [grads[n].to(torch.float32, copy=True) for n in names]
        step, scale = _moments_step(
            cfg, names, parts, [state.m[n] for n in names],
            [state.v[n] for n in names], g32, gnorm, state.step, lr_scale)
        # Re-form each parameter block from the ranks' updated parts.
        for n, part in zip(names, parts):
            block = coarsen_block(part, moment_shardings[n],
                                  param_shardings[n])
            if block is not part:
                params[n].copy_(block)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "clip_scale": scale}
