"""Rank-side half of `tests/test_torch_cell_mesh.py`: what each gloo rank
on the CPU runs (`repro_torch.launch.mesh.run_ranks`). It imports torch
and the port only, never JAX: the ranks are processes of their own that
import it by name.

Two sessions: ``moe_2x1`` on two ranks (a data-only mesh) and
``cells_2x2`` on four. Both take one train step of reduced
deepseek-moe-16b at its production capacity factor, with the MoE layers
on the global dispatch; ``cells_2x2`` also runs the prefill and decode
plans of four archs. Results are numpy arrays (whole arrays on rank
0)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import init_caches
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig

B, LR, TOTAL = 4, 3e-4, 10
#: The MoE steps: the mesh, T (odd on 2 x 2, so that the experts, which
#: split over "model", take the global dispatch) and the config's
#: tp_size.
MOE_STEPS = {"2x1": ((2, 1), 16, 1), "2x2": ((2, 2), 15, 2)}
MOE_CF = 1.25
#: The serve plans on 2 x 2: arch -> tp_size (qwen2 at 4: its 2 KV heads
#: do not divide it, so its caches split by sequence over "model").
SERVE_ARCHS = {"qwen2-1.5b": 4, "hymba-1.5b": 2, "xlstm-350m": 2,
               "deepseek-moe-16b": 2}
PREFILL_T, DECODE_S, DECODE_STEPS = 64, 16, 6
#: The MoE's decode: a batch of 5, which "data" does not divide (every
#: rank holds it whole), at the capacity factor that drops, on the global
#: dispatch (T = 1). Its prefill (on the expert-parallel dispatch, whose
#: capacity is per slice) keeps the reduced config's factor, which never
#: drops.
MOE_DECODE_B = 5


def serve_cfg(arch: str, part: str):
    """The config of ``arch``'s serve plan ``part`` on 2 x 2."""
    moe_decode = arch == "deepseek-moe-16b" and part == "decode"
    return cfg_of(arch, SERVE_ARCHS[arch], MOE_CF if moe_decode else None)


def cfg_of(arch: str, tp: int, capacity_factor=None):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), tp_size=tp)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class _DropTap:
    """Counts the assignments over capacity of every global-dispatch
    routing (`moe.route`) while installed."""

    def __enter__(self):
        self.drops, self._route = 0, tmoe.route

        def tapped(params, xt, cfg):
            r = self._route(params, xt, cfg)
            self.drops += int(tmoe.dropped(r))
            return r

        tmoe.route = tapped
        return self

    def __exit__(self, *exc):
        tmoe.route = self._route


def _moe_step(mesh, key, params, tokens) -> dict:
    """One step of reduced deepseek on ``mesh`` (None: one device)."""
    shape, T, tp = MOE_STEPS[key]
    cfg = cfg_of("deepseek-moe-16b", tp, MOE_CF)
    model = convert.lm_params(params, cfg, device="cpu")
    plan = S.make_train_step(cfg, mesh, ShapeConfig("t", T, B, "train"),
                             opt_cfg=AdamWConfig(lr=LR), total_steps=TOTAL,
                             warmup_steps=0)
    state = plan.init_state(model)
    t = torch.as_tensor(tokens, dtype=torch.int64)
    batch = {"tokens": t, "labels": t}
    if mesh is not None:
        batch = S.batch_rows(batch, mesh)
    with _DropTap() as tap:
        state, m = plan(state, batch)
    out = {k: float(m[k]) for k in ("loss", "ce", "aux", "grad_norm")}
    out["drops"] = tap.drops
    if mesh is None:
        out["params"] = {n: _np(p) for n, p in
                         state.params.named_parameters()}
    else:
        sh = plan.state_shardings().params
        out["params"] = {n: _np(sh[n].gather(b))
                         for n, b in state.params.items()}
    return out


def moe_2x1(ctx, inp) -> dict:
    mesh = M.make_debug_mesh(2, 1)
    out = {"mesh": _moe_step(mesh, "2x1", inp["moe_params"]["2x1"],
                             inp["moe_tokens"]["2x1"])}
    if ctx.rank == 0:
        out["one"] = _moe_step(None, "2x1", inp["moe_params"]["2x1"],
                               inp["moe_tokens"]["2x1"])
    return out


def _serve(mesh, arch: str, params, tokens) -> dict:
    """The prefill plan's logits and each decode step's (teacher-forced
    ``tokens [Bd, DECODE_STEPS]``) of ``arch`` on ``mesh`` (None: one
    device): the rank's rows."""
    cfg = serve_cfg(arch, "prefill")
    out = {}
    plan = S.make_prefill_step(cfg, mesh, ShapeConfig(
        "p", PREFILL_T, B, "prefill"))
    p = plan.bind(convert.lm_params(params, cfg, device="cpu"))
    out["prefill"] = _np(plan(p, plan.rows(torch.as_tensor(
        tokens["prefill"], dtype=torch.int64))))
    cfg = serve_cfg(arch, "decode")
    Bd = len(tokens["decode"])
    plan = S.make_decode_step(cfg, mesh, ShapeConfig(
        "d", DECODE_S, Bd, "decode"))
    p = plan.bind(convert.lm_params(params, cfg, device="cpu"))
    caches = plan.cache_blocks(init_caches(cfg, Bd, DECODE_S, device="cpu"))
    toks = torch.as_tensor(tokens["decode"], dtype=torch.int64)
    logits = []
    with _DropTap() as tap:
        for i in range(DECODE_STEPS):
            lg, caches = plan(p, caches, plan.rows(toks[:, i:i + 1]), i)
            logits.append(_np(lg))
    out["decode"] = np.stack(logits)
    out["decode_drops"] = tap.drops
    return out


def cells_2x2(ctx, inp) -> dict:
    mesh = M.make_debug_mesh(2, 2)
    out = {"moe": {"mesh": _moe_step(mesh, "2x2", inp["moe_params"]["2x2"],
                                     inp["moe_tokens"]["2x2"])},
           "coords": dict(mesh.coords), "serve": {}}
    if ctx.rank == 0:
        out["moe"]["one"] = _moe_step(None, "2x2", inp["moe_params"]["2x2"],
                                      inp["moe_tokens"]["2x2"])
    for i, arch in enumerate(SERVE_ARCHS):
        res = {"mesh": _serve(mesh, arch, inp["serve_params"][arch],
                              inp["serve_tokens"][arch])}
        if ctx.rank == i:
            res["one"] = _serve(None, arch, inp["serve_params"][arch],
                                inp["serve_tokens"][arch])
        out["serve"][arch] = res
    return out
