"""Rank-side halves of the mesh tests (`tests/test_torch_mesh_*.py`).

Each session runs on every rank of `repro_torch.launch.mesh.run_ranks`
(four gloo ranks on the CPU) and returns numpy arrays for the parent to
hold against its oracles. This module imports torch and the port only,
never JAX or the JAX package: the ranks are processes of their own that
import it by name, and the JAX oracles are computed in the test process."""
from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

import repro_torch.core as C
from repro_torch import convert
from repro_torch import distributed as X
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.types import LinearizedSSM
from repro_torch.launch import mesh as M
from repro_torch.models import moe as tmoe
from repro_torch.models import prefill
from repro_torch.models import xlstm as txl

#: The meshes of the sessions: four ranks as 1 x 4 and 2 x 2 ("data",
#: "model").
SHAPES = ((1, 4), (2, 2))


class Pair(NamedTuple):
    u: torch.Tensor
    w: torch.Tensor


def _np(x):
    """Tensors (in tuples, dicts, NamedTuples) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x


def psd(rng, shape, k):
    """Random symmetric positive definite ``shape + (k, k)`` matrices."""
    a = rng.standard_normal(shape + (k, k))
    return a @ np.swapaxes(a, -1, -2) / k + 0.1 * np.eye(k)


def random_ssm(rng, B, n, nx=3, ny=2):
    """A random linearized model ``[B, n]`` with its measurements and a
    prior (``m0 = 0``, ``P0 = I``), float64 numpy arrays by field."""
    return dict(F=np.eye(nx) + 0.3 * rng.standard_normal((B, n, nx, nx)),
                c=0.1 * rng.standard_normal((B, n, nx)),
                Qp=psd(rng, (B, n), nx),
                H=rng.standard_normal((B, n, ny, nx)),
                d=0.1 * rng.standard_normal((B, n, ny)),
                Rp=psd(rng, (B, n), ny),
                ys=rng.standard_normal((B, n, ny)),
                m0=np.zeros(nx), P0=np.eye(nx))


def rank_input(rank: int) -> torch.Tensor:
    """Rank ``rank``'s operand of the collectives: ``[4, 6]`` float64."""
    return torch.arange(24, dtype=torch.float64).reshape(4, 6) ** 1.5 \
        + 100.0 * rank


def _raises(fn, error=NameError):
    try:
        fn()
    except error as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Collectives, exclusive scans, sharded scans, drivers
# ---------------------------------------------------------------------------

def _collectives(ctx) -> dict:
    x = rank_input(ctx.rank)
    out = {}
    for shape in SHAPES:
        mesh = M.make_debug_mesh(*shape)
        with mesh:
            D = X.axis_size("model")
            res = {
                "index": (X.axis_index("data"), X.axis_index("model")),
                "size": (X.axis_size("data"), D,
                         X.axis_size(("data", "model"))),
                "shift": X.ppermute(x, "model",
                                    [(j, (j + 1) % D) for j in range(D)]),
                "partial": X.ppermute(x, "model",
                                      [(j, j + 1) for j in range(D - 1)]),
                "pair": X.ppermute(Pair(x, 2 * x), "model",
                                   [(j, (j - 1) % D) for j in range(D)]),
                "psum": X.psum(x, "model"),
                "psum_all": X.psum(x, ("data", "model")),
                "pmean": X.pmean(x, "model"),
                "pmax": X.pmax(-x, "model"),
                "gather": X.all_gather(x, "model"),
                "gather_tiled": X.all_gather(x, "model", axis=1, tiled=True),
                "scatter_tiled": X.psum_scatter(x, "model", tiled=True),
                "scatter": X.psum_scatter(x[:D], "model"),
                "scatter_tiled_dim1": X.psum_scatter(
                    x[:, :4], "model", scatter_dimension=1, tiled=True),
                "a2a_tiled": X.all_to_all(x, "model", 0, 1, tiled=True),
                "a2a": X.all_to_all(x[:D], "model", 0, 1),
                "unbound_axis": _raises(lambda: X.axis_index("pod")),
                "input_kept": bool(torch.equal(x, rank_input(ctx.rank))),
            }
        res["outside_mesh"] = _raises(lambda: X.psum(x, "model"))
        out[shape] = _np(res)
    return out


def _matmul_combine(a, b):
    return (a[0] @ b[0],)


def _exclusive(ctx, mats) -> dict:
    mesh = M.make_debug_mesh(1, ctx.world_size)
    agg = (torch.as_tensor(mats[ctx.rank]),)
    ident = (torch.eye(mats.shape[-1], dtype=torch.float64),)
    with mesh:
        return {rev: C.device_exclusive_scan(
            _matmul_combine, agg, axis_name="model", identity=ident,
            reverse=rev)[0].numpy() for rev in (False, True)}


_COMBINES = {"filtering": (C.filtering_combine, C.filtering_identity),
             "smoothing": (C.smoothing_combine, C.smoothing_identity)}


def _scan_case(ctx, case, elems):
    kind, batch_dims, n, reverse, impl = case
    D = ctx.world_size
    nl = n // D
    shard = type(elems)(*(torch.as_tensor(x).narrow(
        batch_dims, ctx.rank * nl, nl) for x in elems))
    if kind == "linrec":
        combine = C.linear_recurrence_combine
        one = C.LinearRecurrenceElement(torch.ones_like(shard.a[(0,) * (
            batch_dims + 1)]), torch.zeros_like(shard.b[(0,) * (
                batch_dims + 1)]))
        identity = lambda: one  # noqa: E731
    else:
        combine, make = _COMBINES[kind]
        nx = shard[1].shape[-1]
        identity = lambda: make(nx, torch.float64)  # noqa: E731
    return _np(C.associative_scan(combine, shard, reverse=reverse,
                                  combine_impl=impl, axis_name="model",
                                  identity=identity,
                                  batch_dims=batch_dims))


def _shard_lin(inp, rank, D):
    n = inp["ys"].shape[1]
    sl = slice(rank * (n // D), (rank + 1) * (n // D))
    lin = LinearizedSSM(*(torch.as_tensor(inp[k])[:, sl]
                          for k in LinearizedSSM._fields))
    return lin, torch.as_tensor(inp["ys"])[:, sl], \
        torch.as_tensor(inp["m0"]), torch.as_tensor(inp["P0"])


def _drivers(ctx, inp, impls) -> dict:
    lin, ys, m0, P0 = _shard_lin(inp, ctx.rank, ctx.world_size)
    one = LinearizedSSM(*(x[0] for x in lin))
    ax = dict(axis_name="model")
    out = {}
    with M.make_debug_mesh(1, ctx.world_size):
        for impl in impls:
            kw = dict(ax, combine_impl=impl)
            f = C.parallel_filter(one, ys[0], m0, P0, **kw)
            out[("parallel_filter", impl)] = f
            out[("parallel_smoother", impl)] = C.parallel_smoother(
                one, f, m0, P0, **kw)
            out[("parallel_filter_smoother", impl)] = \
                C.parallel_filter_smoother(one, ys[0], m0, P0, **kw)
            fb = C.parallel_filter_batched(lin, ys, m0, P0, **kw)
            out[("parallel_filter_batched", impl)] = fb
            out[("parallel_smoother_batched", impl)] = \
                C.parallel_smoother_batched(lin, fb, m0, P0, **kw)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                out[("parallel_filter_smoother_batched", impl)] = \
                    C.parallel_filter_smoother_batched(lin, ys, m0, P0,
                                                       **kw)
        f = C.sqrt_parallel_filter(one, ys[0], m0, P0, **ax)
        out[("sqrt_parallel_filter", "sqrt")] = f
        out[("sqrt_parallel_smoother", "sqrt")] = C.sqrt_parallel_smoother(
            one, f, m0, P0, **ax)
        fb = C.sqrt_parallel_filter_batched(lin, ys, m0, P0, **ax)
        out[("sqrt_parallel_filter_batched", "sqrt")] = fb
        out[("sqrt_parallel_smoother_batched", "sqrt")] = \
            C.sqrt_parallel_smoother_batched(lin, fb, m0, P0, **ax)
        out["unbound"] = _raises(lambda: C.parallel_filter(
            one, ys[0], m0, P0, axis_name="seq"))
    return _np(out)


def _linrec(ctx, inp) -> dict:
    n = inp["a"].shape[0]
    nl = n // ctx.world_size
    sl = slice(ctx.rank * nl, (ctx.rank + 1) * nl)
    a, b = (torch.as_tensor(inp[k])[sl] for k in ("a", "b"))
    out = {}
    with M.make_debug_mesh(1, ctx.world_size):
        for impl in ("jnp", "fused", "pallas"):
            for h0 in (None, torch.as_tensor(inp["h0"])):
                out[(impl, h0 is not None)] = C.linear_recurrence_scan(
                    a, b, h0=h0, axis_name="model", combine_impl=impl)
    return _np(out)


def scan_session(ctx, inputs) -> dict:
    """Every case of `test_torch_mesh_scan.py` on this rank."""
    with M.make_debug_mesh(1, ctx.world_size):
        scans = {case: _scan_case(ctx, case, elems)
                 for case, elems in inputs["scans"].items()}
    return {
        "collectives": _collectives(ctx),
        "exclusive": _exclusive(ctx, inputs["mats"]),
        "scans": scans,
        "drivers": _drivers(ctx, inputs["ssm"], inputs["impls"]),
        "linrec": _linrec(ctx, inputs["linrec"]),
    }


# ---------------------------------------------------------------------------
# The sequence-parallel mLSTM and the expert-parallel MoE
# ---------------------------------------------------------------------------

def _batch_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the batch along "data"."""
    B = x.shape[0] // mesh.shape["data"]
    return x[mesh.coords["data"] * B:(mesh.coords["data"] + 1) * B]


def _no_exchange(combine, agg, *, axis_name, identity, reverse=False):
    """A planted fault: the state that reaches a slice is dropped."""
    return identity


def _mlstm_cases(ctx, inp) -> dict:
    cfg = reduced_config(get_config("xlstm-350m"))
    model = convert.lm_params(inp["xlstm_params"], cfg, device="cpu")
    layer = model.runs[0][0].mlstm
    out = {}
    for shape in SHAPES:
        mesh = M.make_debug_mesh(*shape)
        with mesh:
            x = _batch_shard(torch.as_tensor(inp["mlstm_x"]), mesh)
            out[("layer", shape)] = txl.mlstm_layer(layer, x, cfg)[0]
            toks = _batch_shard(torch.as_tensor(inp["xlstm_tokens"]), mesh)
            out[("prefill", shape)] = prefill(model, cfg, toks)
            q, k, v, lf, li = (_batch_shard(torch.as_tensor(a), mesh)
                               for a in inp["long_gates"])
            out[("sp", shape)] = txl._mlstm_sp(q, k, v, lf, li,
                                               cfg.scan_chunk, mesh)
            real = txl.device_exclusive_scan
            txl.device_exclusive_scan = _no_exchange
            try:
                out[("sp_fault", shape)] = txl._mlstm_sp(
                    q, k, v, lf, li, cfg.scan_chunk, mesh)
            finally:
                txl.device_exclusive_scan = real
    return out


def _moe_cases(ctx, inp) -> dict:
    cfg = reduced_config(get_config("deepseek-moe-16b"))
    whole = convert.lm_params(inp["moe_params"], cfg,
                              device="cpu").runs[0][0].moe
    out = {}
    for shape in SHAPES:
        mesh = M.make_debug_mesh(*shape)
        model = convert.lm_params(inp["moe_params"], cfg, device="cpu",
                                  mesh=mesh)
        layer = model.runs[0][0].moe
        out[("weights", shape)] = {
            "w_gate": layer.w_gate, "w_down": layer.w_down,
            "shared_gate": layer.shared.w_gate.weight,
            "shared_down": layer.shared.w_down.weight,
            "router": layer.router}
        x = _batch_shard(torch.as_tensor(inp["moe_x"]), mesh)
        with mesh:
            for cf in (2.0, 0.5):
                c = dataclasses.replace(cfg, capacity_factor=cf)
                out[("layer", shape, cf)] = tmoe.moe_layer(layer, x, c)
            # A rank that holds every expert must shard them first.
            out[("layer_whole", shape)] = _raises(
                lambda: tmoe.moe_layer(whole, x, cfg), ValueError)
            mine = copy.deepcopy(whole)
            tmoe.shard_experts(mine, cfg, mesh.coords["model"],
                               mesh.shape["model"])
            out[("layer_sharded_here", shape)] = tmoe.moe_layer(mine, x, cfg)
            toks = _batch_shard(torch.as_tensor(inp["moe_tokens"]), mesh)
            out[("prefill", shape)] = prefill(model, cfg, toks)
            try:
                tmoe.moe_layer(layer, x[:, :1], cfg)
                out[("decode", shape)] = None
            except ValueError as e:
                out[("decode", shape)] = str(e)
    return out


def _fault_inputs(ctx, inp) -> dict:
    """The port's sharded drivers on the inputs that show the reference's
    sharded-driver fault (ROADMAP C7)."""
    lin, ys, m0, P0 = _shard_lin(inp, ctx.rank, ctx.world_size)
    one = LinearizedSSM(*(x[0] for x in lin))
    with M.make_debug_mesh(1, ctx.world_size):
        f, s = C.parallel_filter_smoother(one, ys[0], m0, P0,
                                          axis_name="model")
        qf = C.sqrt_parallel_filter(one, ys[0], m0, P0, axis_name="model")
        qs = C.sqrt_parallel_smoother(one, qf, m0, P0, axis_name="model")
    return _np({"filter": f, "smoother": s, "sqrt_filter": qf,
                "sqrt_smoother": qs})


def model_session(ctx, inputs) -> dict:
    """Every rank-side case of `test_torch_mesh_models.py`."""
    return _np({"mlstm": _mlstm_cases(ctx, inputs),
                "moe": _moe_cases(ctx, inputs),
                "fault": _fault_inputs(ctx, inputs["fault"])})
