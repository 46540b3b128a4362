"""Rank-side half of `tests/test_torch_mesh_train.py`: what each of four
gloo ranks on the CPU runs (`repro_torch.launch.mesh.run_ranks`), once for
the module. It imports torch and the port only, never JAX or the JAX
package: the ranks are processes of their own that import it by name,
and the JAX oracles run in the test process and its subprocesses.

Every case returns numpy arrays (rank 0's whole arrays where the ranks
hold blocks) for the parent to hold against its oracles."""
from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch import distributed as X
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import moe as tmoe
from repro_torch.models import xlstm as txl
from repro_torch.models.transformer import init_model
from repro_torch.optim import AdamWConfig, compressed_psum, init_compression
from repro_torch.runtime.elastic import reshard_state, shardings_for

#: The sharded steps: the mesh, the global batch, the steps, the AdamW
#: settings and each arch's sequence length (xlstm-350m: one 32-step
#: chunk per rank at tp = 2, so its mLSTM layers run sequence-parallel)
#: and capacity factor. No warmup, so that both steps move the
#: parameters, at the reference's learning rate: AdamW's update
#: ``m / sqrt(v)`` of an element whose gradient is near zero (a few in
#: each model) turns the gradients' float32 rounding into a difference of
#: up to about ``lr / 100``, which at 3e-4 stays well inside TOL's atol.
SHAPE = (2, 2)
B, STEPS, LR, TOTAL = 4, 2, 3e-4, 10
STEP_ARCHS = {"qwen2-1.5b": (64, None), "deepseek-moe-16b": (64, 1.25),
              "xlstm-350m": (64, None)}
#: deepseek's drop-free capacity factor, E / k, for the mesh step against
#: the one-device step.
DROP_FREE = 2.0


def cfg_of(arch: str, tp: int = 2, capacity_factor=None):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), tp_size=tp)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _inner(a, b) -> torch.Tensor:
    return (a * b).sum()


# ---------------------------------------------------------------------------
# Adjoints of the collectives
# ---------------------------------------------------------------------------

def _adjoints(ctx, mesh) -> dict:
    """Σ_ranks <C(x), y> and Σ_ranks <x, Cᵀ(y)> for each differentiable
    collective on the 2 x 2 mesh (float64), Cᵀ by autograd. A value
    replicated over the collective's axis is drawn alike on its ranks and
    counted once (its inner product divided by the axis size)."""
    D = mesh.shape["model"]
    dcoord = mesh.coords["data"]

    def draw(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=torch.float64)

    varying = lambda s, shape: draw(1000 * s + ctx.rank, shape)  # noqa
    replicated = lambda s, shape: draw(1000 * s + 100 + dcoord,  # noqa
                                       shape)
    everywhere = lambda s, shape: draw(1000 * s + 200, shape)  # noqa
    # (collective, x replicated over "model", output replicated over it;
    # "all": over the whole mesh)
    cases = {
        "ppermute": (lambda t: X.ppermute(
            t, "model", [(j, (j + 1) % D) for j in range(D)]), False, False),
        "psum": (lambda t: X.psum(t, "model"), False, True),
        "psum_all": (lambda t: X.psum(t, ("data", "model")), False,
                     "all"),
        "pmean": (lambda t: X.pmean(t, "model"), False, True),
        "all_gather": (lambda t: X.all_gather(t, "model"), False, True),
        "all_gather_tiled": (lambda t: X.all_gather(
            t, "model", axis=1, tiled=True), False, True),
        "psum_scatter": (lambda t: X.psum_scatter(t, "model"), False, False),
        "psum_scatter_tiled": (lambda t: X.psum_scatter(
            t, "model", scatter_dimension=1, tiled=True), False, False),
        "all_to_all": (lambda t: X.all_to_all(t, "model", 0, 1), False,
                       False),
        "all_to_all_tiled": (lambda t: X.all_to_all(
            t, "model", 0, 1, tiled=True), False, False),
        "pvary": (lambda t: X.pvary(t, "model"), True, False),
    }
    out = {}
    with mesh:
        for i, (name, (fn, x_rep, y_rep)) in enumerate(cases.items()):
            shape = (D, 6) if name.startswith(("psum_scatter",
                                               "all_to_all")) else (4, 6)
            x = (replicated if x_rep else varying)(i, shape)
            x.requires_grad_(True)
            y_out = fn(x)
            draw_y = {False: varying, True: replicated,
                      "all": everywhere}[y_rep]
            y = draw_y(50 + i, y_out.shape)
            (ct,) = torch.autograd.grad(y_out, x, y)
            copies = {False: 1, True: D, "all": mesh.size}[y_rep]
            lhs = _inner(y_out.detach(), y) / copies
            rhs = _inner(x.detach(), ct) / (D if x_rep else 1)
            pair = X.psum(torch.stack([lhs, rhs]), ("data", "model"))
            out[name] = _np(pair)
    return out


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------

class _DropTap:
    """Counts the assignments over capacity in every expert-parallel
    routing (`moe._route_local`) while it is installed."""

    def __init__(self):
        self.drops = 0

    @contextlib.contextmanager
    def installed(self):
        route = tmoe._route_local

        def tapped(xt, router, cfg):
            out = route(xt, router, cfg)
            self.drops += int(tmoe.dropped(out[1]))
            return out

        tmoe._route_local = tapped
        try:
            yield self
        finally:
            tmoe._route_local = route


def _steps(cfg, mesh, T, params, tokens, steps=STEPS):
    """``steps`` steps of the port's plan (on ``mesh``, or one device
    where it is None) from the JAX parameters ``params`` (numpy) on
    ``tokens`` (labels = tokens, as in the reference's recipe). Returns
    (losses, grad norms, the plan, the final state)."""
    model = convert.lm_params(params, cfg, device="cpu")
    plan = S.make_train_step(cfg, mesh, ShapeConfig("t", T, B, "train"),
                             opt_cfg=AdamWConfig(lr=LR), total_steps=TOTAL,
                             warmup_steps=0)
    state = plan.init_state(model)
    t = torch.as_tensor(tokens, dtype=torch.int64)
    batch = {"tokens": t, "labels": t}
    if mesh is not None:
        batch = S.batch_rows(batch, mesh)
    losses, norms = [], []
    for _ in range(steps):
        state, m = plan(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, plan, state


def _whole(plan, state) -> dict:
    """The state's whole arrays by name (a collective: every rank)."""
    sh = plan.state_shardings()
    out = {}
    for part, tree, shs in (("params", state.params, sh.params),
                            ("m", state.opt.m, sh.opt.m),
                            ("v", state.opt.v, sh.opt.v)):
        out[part] = {n: _np(shs[n].gather(t)) for n, t in tree.items()}
    return out


def _one_device_whole(state) -> dict:
    return {"params": {n: _np(p) for n, p in
                       state.params.named_parameters()},
            "m": {n: _np(t) for n, t in state.opt.m.items()},
            "v": {n: _np(t) for n, t in state.opt.v.items()}}


@contextlib.contextmanager
def _counted_sp(calls: list):
    """Counts the calls of `xlstm._mlstm_sp` while installed."""
    sp = txl._mlstm_sp

    def counted(*a, **k):
        calls.append(1)
        return sp(*a, **k)

    txl._mlstm_sp = counted
    try:
        yield calls
    finally:
        txl._mlstm_sp = sp


def _train_steps(ctx, inp, mesh) -> dict:
    """Each arch's 2 steps on the mesh (the drops of deepseek's routing
    and the sequence-parallel calls counted; the whole state on rank 0),
    then the one-device steps on the same inputs (the MoE at its
    drop-free capacity), arch ``i`` on rank ``i``. Returns the results
    and qwen2's plan and state for the checkpoint cases."""
    out, kept, one_device = {}, None, []
    for arch, (T, cf) in STEP_ARCHS.items():
        cfg = cfg_of(arch, capacity_factor=cf)
        tap, sp_calls = _DropTap(), []
        with tap.installed(), _counted_sp(sp_calls):
            losses, norms, plan, state = _steps(
                cfg, mesh, T, inp["params"][arch], inp["tokens"][arch])
        if arch == "qwen2-1.5b":
            kept = (plan, state)
        whole = _whole(plan, state)
        res = {"loss": losses, "grad_norm": norms, "drops": tap.drops,
               "sp_calls": len(sp_calls)}
        if ctx.rank == 0:
            res["whole"] = whole
        if cf is not None:
            cfg = cfg_of(arch, capacity_factor=DROP_FREE)
            losses, norms, plan, state = _steps(
                cfg, mesh, T, inp["params"][arch], inp["tokens"][arch])
            whole = _whole(plan, state)
            res["drop_free"] = {"loss": losses, "grad_norm": norms}
            if ctx.rank == 0:
                res["drop_free"]["whole"] = whole
        one_device.append((arch, cfg, T))
        out[arch] = res
    if ctx.rank < len(one_device):
        arch, cfg, T = one_device[ctx.rank]
        losses, norms, _, state = _steps(cfg, None, T, inp["params"][arch],
                                         inp["tokens"][arch])
        out[arch]["one_device"] = {"loss": losses, "grad_norm": norms,
                                   "whole": _one_device_whole(state)}
    return out, kept


# ---------------------------------------------------------------------------
# The mixers' gradients under the mesh
# ---------------------------------------------------------------------------

def _sum_data(t: torch.Tensor) -> torch.Tensor:
    return X.psum(t, "data")


def _mixer_grads(ctx, inp, mesh) -> dict:
    """Gradients of ``sum(out * ct) (+ 0.1 aux)`` of `moe_layer` (the
    expert-parallel dispatch) and `mlstm_layer` (sequence-parallel) under
    the 2 x 2 mesh: every parameter's whole gradient (shards gathered,
    the data ranks' parts summed) and the rank's rows of x's."""
    out = {}
    rows = lambda a: S.batch_rows({"x": torch.as_tensor(a)}, mesh)["x"]  # noqa
    with mesh:
        # The MoE layer of deepseek's layer 0, its experts sharded.
        cfg = cfg_of("deepseek-moe-16b")
        model = convert.lm_params(inp["params"]["deepseek-moe-16b"], cfg,
                                  device="cpu")
        layer = model.runs[0][0].moe
        tmoe.shard_model(model, cfg, mesh)
        x = rows(inp["moe_x"]).requires_grad_(True)
        ct = rows(inp["moe_ct"])
        y, aux = tmoe.moe_layer(layer, x, cfg)
        loss = X.psum(_inner(y, ct), "data") + 0.1 * aux
        names = [n for n, _ in layer.named_parameters()]
        params = [p for _, p in layer.named_parameters()]
        grads = torch.autograd.grad(loss, params + [x])
        g = {}
        specs = {"w_gate": X.P("model"), "w_up": X.P("model"),
                 "w_down": X.P("model"), "shared.w_gate.weight":
                 X.P("model"), "shared.w_up.weight": X.P("model"),
                 "shared.w_down.weight": X.P(None, "model")}
        for n, gr in zip(names, grads[:-1]):
            gr = _sum_data(gr)
            if n in specs:
                gr = X.NamedSharding(mesh, specs[n]).gather(gr)
            g[n] = _np(gr)
        out["moe"] = {"grads": g, "x": _np(grads[-1]),
                      "loss": float(loss)}

        cfg = cfg_of("xlstm-350m")
        model = convert.lm_params(inp["params"]["xlstm-350m"], cfg,
                                  device="cpu")
        layer = model.runs[0][0].mlstm
        x = rows(inp["mlstm_x"]).requires_grad_(True)
        ct = rows(inp["mlstm_ct"])
        with _counted_sp([]) as calls:
            y, _ = txl.mlstm_layer(layer, x, cfg, impl="plain")
        loss = X.psum(_inner(y, ct), "data")
        names = [n for n, _ in layer.named_parameters()]
        params = [p for _, p in layer.named_parameters()]
        grads = torch.autograd.grad(loss, params + [x])
        out["mlstm"] = {"grads": {n: _np(_sum_data(gr)) for n, gr in
                                  zip(names, grads[:-1])},
                        "x": _np(grads[-1]), "loss": float(loss),
                        "sp_calls": len(calls)}
    return out


# ---------------------------------------------------------------------------
# Compression, checkpoints, elastic restart
# ---------------------------------------------------------------------------

def _compression(ctx, inp) -> dict:
    mesh = M.make_mesh((4,), ("pod",))
    g = torch.as_tensor(inp["psum_g"][ctx.rank])
    with mesh:
        state = init_compression({"g": g})
        got, new = compressed_psum({"g": g}, state, "pod")
        exact = X.psum(g, "pod")
    return {"got": _np(got["g"]), "residual": _np(new.residual["g"]),
            "psum": _np(exact)}


def _checkpoints(ctx, tmp, mesh22, plan, state) -> dict:
    out = {}
    # The reference's test_restore_onto_different_mesh: an 8 x 8 array
    # saved from a (4,) mesh as P("data", None), restored onto 2 x 2 as
    # P("model", "data").
    d = os.path.join(tmp, "reshard")
    mesh4 = M.make_mesh((4,), ("data",))
    w = torch.arange(64.0).reshape(8, 8)
    sharded = reshard_state({"w": w}, mesh4, {"w": X.P("data", None)})
    mgr = CheckpointManager(d)
    mgr.save(1, sharded, shardings=shardings_for(
        mesh4, {"w": X.P("data", None)}))
    shards = shardings_for(mesh22, {"w": X.P("model", "data")})
    like = {"w": torch.zeros(shards["w"].shard_shape((8, 8)))}
    restored = CheckpointManager(d).restore(like, shardings=shards)
    out["reshard"] = {"block": _np(restored["w"]),
                      "whole": _np(shards["w"].gather(restored["w"])),
                      "saved_block": _np(sharded["w"])}

    # A mesh's state (qwen2 after its steps) restores onto one device,
    # and one device's onto the mesh.
    cfg = plan.cfg
    d = os.path.join(tmp, "from_mesh")
    CheckpointManager(d).save(1, state, shardings=plan.state_shardings())
    whole = _whole(plan, state)
    if ctx.rank == 0:
        one = S.init_train_state(init_model(cfg, 1, device="cpu"))
        CheckpointManager(d).restore(one)
        got = _one_device_whole(one)
        out["to_one_device"] = all(
            np.array_equal(got[k][n], whole[k][n])
            for k in whole for n in whole[k])
    d = os.path.join(tmp, "from_one")
    src = S.init_train_state(init_model(cfg, 2, device="cpu"))
    if ctx.rank == 0:
        CheckpointManager(d).save(3, src)
    dist.barrier()
    mgr = CheckpointManager(d)
    fresh = plan.init_state(init_model(cfg, 3, device="cpu"))
    mgr.restore(fresh, shardings=plan.state_shardings())
    sh = plan.state_shardings()
    full = dict(src.params.named_parameters())
    out["to_mesh"] = all(
        torch.equal(sh.params[n].block(full[n]), fresh.params[n])
        for n in full) and all(
        torch.equal(sh.opt.m[n].block(src.opt.m[n]), fresh.opt.m[n])
        for n in full) and int(fresh.opt.step) == int(src.opt.step)
    return out


def _elastic(ctx, tmp) -> dict:
    """2 steps on 2 x 2 with a checkpoint, resumed for a third on 1 x 4,
    against 3 uninterrupted steps on 2 x 2 (the run that wrote the
    checkpoint)."""
    base = dict(arch="qwen2-1.5b", steps=3, seq_len=32, global_batch=B,
                ckpt_every=2, log_every=100, lr=LR, warmup_steps=1,
                device="cpu")
    straight, resumed = (os.path.join(tmp, n) for n in ("straight",
                                                         "resumed"))
    log = []
    out3 = TR.train(TR.TrainLoopConfig(mesh_shape=(2, 2),
                                       ckpt_dir=straight, **base),
                    emit=log.append)
    if ctx.rank == 0:
        mgr = CheckpointManager(straight)
        shutil.copytree(mgr.path_for(2),
                        CheckpointManager(resumed).path_for(2))
    dist.barrier()
    out1 = TR.train(TR.TrainLoopConfig(mesh_shape=(1, 4), ckpt_dir=resumed,
                                       **base), emit=log.append)
    res = {"straight": out3, "resumed": out1, "log": log}
    if ctx.rank == 0:
        a, b = (CheckpointManager(d) for d in (straight, resumed))
        res["final"] = {}
        for mgr, key in ((a, "straight"), (b, "resumed")):
            path = mgr.path_for(3)
            arrays = {}
            for f in sorted(os.listdir(path)):
                if f.endswith(".npy"):
                    arrays[f] = np.load(os.path.join(path, f))
            res["final"][key] = arrays
    # A mesh of another size than the process group's raises.
    try:
        TR.train(TR.TrainLoopConfig(mesh_shape=(2, 1), **dict(
            base, steps=1)), emit=log.append)
        res["wrong_size"] = None
    except ValueError as e:
        res["wrong_size"] = str(e)
    return res


def session(ctx, inp, tmp) -> dict:
    """Every case, on every rank."""
    torch.manual_seed(0)
    mesh = M.make_debug_mesh(*SHAPE)
    steps, (plan, state) = _train_steps(ctx, inp, mesh)
    return {"adjoints": _adjoints(ctx, mesh),
            "steps": steps,
            "mixers": _mixer_grads(ctx, inp, mesh),
            "compression": _compression(ctx, inp),
            "checkpoints": _checkpoints(ctx, tmp, mesh, plan, state),
            "elastic": _elastic(ctx, tmp)}
