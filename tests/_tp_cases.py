"""Rank-side half of `tests/test_torch_tensor_parallel.py`: what each of
four gloo ranks on the CPU runs (`repro_torch.launch.mesh.run_ranks`) on
a 2 x 2 ("data", "model") mesh, once for the module. It imports torch
and the port only, never JAX or the JAX package.

Every case returns numpy arrays: the rank's rows of the logits, and for
the train step the whole parameters (rank 0), the metrics and the
compute blocks of the SSM's ``in_proj``."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch import distributed as X
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.models import init_caches
from repro_torch.optim import AdamWConfig

#: The configs, by key: (arch, fields replaced in its reduced config).
#: The reduced configs have tp_size 1, so padded heads and a replicated
#: kv projection arise only where tp_size is set past the kv heads: "odd"
#: (3 heads padded to 4, one kv head) and "uneven" (6 heads padded to 8
#: on 2 kv heads, so that at "model" 2 rank 0's q heads read kv heads 0,
#: 0, 0, 1: the full-width qwen2-1.5b's pattern); reduced qwen2-vl-72b,
#: whose M-RoPE rotates the rank's heads; reduced hymba-1.5b with 10 heads
#: padded to 12 on 2 replicated kv heads (rank 0's q heads read kv heads
#: 0, 0, 0, 0, 0, 1: hymba's pattern) and a window of 8 ("hybrid"), or
#: its own window of 32 ("hybrid_w32", decode alone: its rings of 32 rows
#: split along the sequence); and reduced seamless-m4t-medium (its kv
#: heads split) with a memory of 16 rows.
CASES = {
    "qwen2": ("qwen2-1.5b", dict(tp_size=2)),
    "codeqwen": ("codeqwen1.5-7b", dict(tp_size=2)),
    "odd": ("qwen2-1.5b", dict(tp_size=2, num_heads=3, num_kv_heads=1)),
    "uneven": ("qwen2-1.5b", dict(tp_size=4, num_heads=6, num_kv_heads=2)),
    "qwen2vl": ("qwen2-vl-72b", dict(tp_size=2)),
    "hybrid": ("hymba-1.5b", dict(tp_size=4, num_heads=10, num_kv_heads=2,
                                  sliding_window=8)),
    "hybrid_w32": ("hymba-1.5b", dict(tp_size=4, num_heads=10,
                                      num_kv_heads=2)),
    "encdec": ("seamless-m4t-medium", dict(tp_size=2, encoder_seq_len=16)),
}
SHAPE = (2, 2)
B, T, DECODE_STEPS, LR, TOTAL = 4, 16, 4, 3e-4, 10
#: Decode caches: 32 rows (split along the sequence over "model" where
#: the kv heads are replicated; a ring of 8 rows whole), and 8 rows (too
#: short for that: whole on every rank, read through the uneven head
#: map).
CACHES = (32, 8)
#: Cases that run the decode plans alone, at these capacities.
DECODE_ONLY = {"hybrid_w32": (32,)}
#: Teacher-forced decode steps where not `DECODE_STEPS` (the prompt's
#: tokens again past T): past the wrap of hybrid's rings of 8 rows and of
#: hybrid_w32's split rings of 32.
STEPS = {"hybrid": 12, "hybrid_w32": 36}


def cfg_of(key: str):
    arch, fields = CASES[key]
    return dataclasses.replace(reduced_config(get_config(arch)), **fields)


def caches_of(key: str) -> tuple:
    return DECODE_ONLY.get(key, CACHES)


def steps_of(key: str) -> int:
    return STEPS.get(key, DECODE_STEPS)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _in_proj(model) -> dict:
    """The compute model's SSM ``in_proj`` blocks, by name."""
    return {n: _np(p).copy() for n, p in model.named_parameters()
            if n.endswith("ssm.in_proj.weight")}


def _train(cfg, mesh, params, tokens, enc_emb=None) -> dict:
    """One step of the port's train plan from the JAX parameters."""
    plan = S.make_train_step(cfg, mesh, ShapeConfig("t", T, B, "train"),
                             opt_cfg=AdamWConfig(lr=LR), total_steps=TOTAL,
                             warmup_steps=0)
    state = plan.init_state(convert.lm_params(params, cfg, device="cpu"))
    t = torch.as_tensor(tokens, dtype=torch.int64)
    batch = {"tokens": t, "labels": t}
    if enc_emb is not None:
        batch["enc_emb"] = torch.as_tensor(enc_emb)
    in_proj = _in_proj(plan.model)
    rest = {n: _np(b).copy() for n, b in state.params.items()
            if n in in_proj}
    state, m = plan(state, S.batch_rows(batch, mesh))
    sh = plan.shardings(plan.param_specs)
    whole = {n: _np(sh[n].gather(b)) for n, b in state.params.items()}
    return {"metrics": {k: float(m[k]) for k in ("loss", "ce", "grad_norm")},
            "params": whole, "tensor_parallel": plan.tensor_parallel,
            "compute_bytes": _bytes(plan.model.parameters()),
            "plan_compute_bytes": plan.compute_param_bytes(),
            "in_proj": in_proj, "in_proj_rest": rest}


def _serve(cfg, mesh, params, tokens, caps, steps, enc_emb=None,
           memory=None, prefill=True) -> dict:
    """The prefill plan's logits, and each decode plan's over ``steps``
    teacher-forced steps, the rank's rows; the compute model from
    `convert.lm_params(mesh=)`, bound as it is."""
    model = convert.lm_params(params, cfg, device="cpu", mesh=mesh)
    out = {"lm_params_tp": getattr(model, "tp_axis", None),
           "in_proj": _in_proj(model)}
    toks = torch.as_tensor(tokens, dtype=torch.int64)
    if prefill:
        pp = S.make_prefill_step(cfg, mesh, ShapeConfig("p", T, B,
                                                        "prefill"))
        extra = [] if enc_emb is None else [pp.rows(torch.as_tensor(
            enc_emb))]
        out["prefill"] = _np(pp(pp.bind(model), pp.rows(toks), *extra))
    for cap in caps:
        dp = S.make_decode_step(cfg, mesh, ShapeConfig("d", cap, B,
                                                       "decode"))
        params_ = dp.bind(model)
        caches = dp.cache_blocks(init_caches(cfg, B, cap, device="cpu"))
        kw = {} if memory is None else {
            "memory": dp.rows(torch.as_tensor(memory))}
        logits = []
        for i in range(steps):
            j = i % T
            lg, caches = dp(params_, caches, dp.rows(toks[:, j:j + 1]), i,
                            **kw)
            logits.append(_np(lg))
        out[f"decode{cap}"] = np.stack(logits)
        out[f"cache_rows{cap}"] = [int(c["attn"].k.shape[3])
                                   for c in caches]
        out[f"lengths{cap}"] = _np(caches[0]["attn"].length)
    return out


def _adjoints(mesh) -> dict:
    """Σ_ranks <R(x), y> and Σ_ranks <x, Rᵀ(y)> for each region function
    over "model" (float64), Rᵀ by autograd. A value replicated over
    "model" is drawn alike on its ranks and counted once."""
    D, dcoord = mesh.shape["model"], mesh.coords["data"]

    def draw(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=torch.float64)

    cases = {  # (function, x replicated, y replicated)
        "copy_to_region": (lambda t: X.copy_to_region(t, "model"), True,
                           False),
        "reduce_from_region": (lambda t: X.reduce_from_region(t, "model"),
                               False, True),
        "gather_sequence": (lambda t: X.gather_sequence(t, "model"), False,
                            False),
        "scatter_sequence": (lambda t: X.scatter_sequence(t, "model"),
                             False, False),
    }
    out = {}
    with mesh:
        for i, (name, (fn, x_rep, y_rep)) in enumerate(cases.items()):
            seed = 1000 * i + (100 + dcoord if x_rep else mesh.rank)
            x = draw(seed, (2, 4, 3)).requires_grad_(True)
            y_out = fn(x)
            y = draw(1000 * i + 500 + (dcoord if y_rep else 10 + mesh.rank),
                     y_out.shape)
            (ct,) = torch.autograd.grad(y_out, x, y)
            lhs = (y_out.detach() * y).sum() / (D if y_rep else 1)
            rhs = (x.detach() * ct).sum() / (D if x_rep else 1)
            out[name] = _np(X.psum(torch.stack([lhs, rhs]),
                                   ("data", "model")))
    return out


def session(ctx, inp) -> dict:
    """Every case, on every rank."""
    torch.manual_seed(0)
    mesh = M.make_debug_mesh(*SHAPE)
    out = {"coords": dict(mesh.coords), "adjoints": _adjoints(mesh)}
    for key in CASES:
        cfg = cfg_of(key)
        only = key in DECODE_ONLY
        enc, mem = (inp.get(f"{k}/{key}") for k in ("enc_emb", "memory"))
        res = {"serve": _serve(cfg, mesh, inp["params"][key],
                               inp["tokens"][key], caches_of(key),
                               steps_of(key), enc, mem, prefill=not only)}
        if not only:
            res["train"] = _train(cfg, mesh, inp["params"][key],
                                  inp["tokens"][key], enc)
            if ctx.rank != 0:
                res["train"].pop("params")
        out[key] = res
    return out
