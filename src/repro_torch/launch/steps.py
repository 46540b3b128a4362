"""The train step and its sharding tables: the JAX package's
``repro.launch.steps`` for training (its prefill/decode cell plans are
the dry-run's, ROADMAP A, item 4c).

`make_train_step(cfg)` on one device is the body of the reference's
step in eager PyTorch on the model's device: ``value_and_grad`` of
`models.train_loss`, the warmup-cosine LR scale at the optimizer's step,
then `optim.adamw_update`.

`make_train_step(cfg, mesh, shape)` is the reference's sharded step on a
("data", "model") mesh (or ("pod", "data", "model")), run on every rank
inside ``with mesh:``:

* at rest a rank holds its blocks of the parameters under the
  reference's specs (`param_and_state_specs`: `sharding.param_specs`,
  FSDP-widened for ``cfg.fsdp_params`` archs) and of the float32
  moments under ``optim.zero_specs`` (ZeRO-1);
* a step all_gathers each parameter into a model held whole on every
  rank (the compute model), except the experts of an expert-parallel
  MoE, which stay the rank's shard; the forward and backward run on the
  rank's rows of the batch with the mixers' expert- and
  sequence-parallel paths;
* each gradient is cut to the rank's moment block and summed over the
  batch axes (a reduce-scatter where the block splits over "data", an
  all-reduce where it does not), and `optim.adamw_update_sharded`
  updates the blocks.

The dense layers therefore run replicated over "model": the reference's
GSPMD would split their matmuls over it too (ROADMAP C records the
difference, and queue B the tensor-parallel compute that would remove
it). `TrainPlan.per_chip_argument_bytes` is computed from the axis sizes
alone (an `AbstractMesh` will do), as the reference's
``CellPlan.per_chip_argument_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import (NamedSharding, P, _extra_axes,
                                     coarsen_block, psum, psum_scatter)
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import batch_axes, batch_shard
from repro_torch.models import train_loss
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import CausalLM
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_update,
                               adamw_update_sharded, init_adamw,
                               warmup_cosine, zero_specs)


class TrainState(NamedTuple):
    params: Any          # one device: the model, updated in place; on a
    #                      mesh: {name: the rank's block}
    opt: AdamWState


def init_train_state(model: CausalLM) -> TrainState:
    """The model with zero float32 moments at step 0 (one device)."""
    return TrainState(params=model, opt=init_adamw(model))


def loss_and_grads(model: CausalLM, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, dict, Dict[str, torch.Tensor]]:
    """``value_and_grad(train_loss)``: (loss, ``{"ce", "aux"}``, the
    gradient of every named parameter). A parameter the loss does not
    reach (a cross-attention's QKV bias, which the reference's
    cross-attention ignores too) gets zeros, as under JAX."""
    params = dict(model.named_parameters())
    loss, metrics = train_loss(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)}


# ---------------------------------------------------------------------------
# Sharding tables
# ---------------------------------------------------------------------------

def _data_size(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def _leaf_specs(cfg: ModelConfig, mesh, for_train: bool):
    """The reference's leaves (`sharding.jax_layout`) with their
    parameter and moment specs on ``mesh``, in its layout: fsdp_widen
    for ``cfg.fsdp_params`` archs in training, zero_specs, then the
    multi-pod adaptation."""
    leaves = shard_lib.jax_layout(cfg)
    dsize = _data_size(mesh)
    sizes = dict(mesh.shape, data=dsize)
    pspec, mspec = {}, {}
    for key, leaf in leaves.items():
        spec = leaf.spec
        if for_train and cfg.fsdp_params:
            spec = shard_lib.fsdp_widen(spec, leaf.shape, data_size=dsize)
        pspec[key] = shard_lib.adapt_specs_for_mesh(spec, mesh)
        if for_train:
            mspec[key] = shard_lib.adapt_specs_for_mesh(
                zero_specs(spec, sizes, leaf.shape).m, mesh)
    return leaves, pspec, mspec


def param_and_state_specs(cfg: ModelConfig, mesh, *, for_train: bool):
    """(shapes, specs, opt shapes, opt specs) as the reference's: every
    parameter's ``(shape, dtype)`` and spec by name, and the AdamW state's
    abstract tensors (`init_adamw_abstract`) and specs (``step`` P(),
    the moments by ``zero_specs``); the last two None unless
    ``for_train``. The specs are adapted to ``mesh`` (a `Mesh` or an
    `AbstractMesh`)."""
    leaves, pspec, mspec = _leaf_specs(cfg, mesh, for_train)
    shapes = shard_lib.param_shapes(cfg)

    def by_name(table):
        out = shard_lib.port_specs(leaves, lambda leaf: table[leaf.keys])
        return {n: out[n] for n in shapes}

    specs = by_name(pspec)
    if not for_train:
        return shapes, specs, None, None
    moments = by_name(mspec)
    return (shapes, specs, init_adamw_abstract(shapes),
            AdamWState(step=P(), m=moments, v=dict(moments)))


def init_adamw_abstract(param_shapes) -> AdamWState:
    """The AdamW state of parameters ``{name: (shape, dtype)}`` as
    ``meta`` tensors: shapes and dtypes, no storage."""
    meta = dict(dtype=torch.float32, device="meta")
    zeros = {n: torch.empty(tuple(s), **meta)
             for n, (s, _) in param_shapes.items()}
    return AdamWState(step=torch.empty((), dtype=torch.int32,
                                       device="meta"),
                      m=zeros, v={n: torch.empty_like(t)
                                  for n, t in zeros.items()})


def _ep_names(cfg: ModelConfig, mesh, seq_len: int, names) -> set:
    """Parameters the compute model keeps as the rank's shard over
    "model": an expert-parallel MoE's experts (`moe._moe_layer_ep`)."""
    tp = mesh.shape.get("model", 1)
    if not (cfg.num_experts and tp > 1 and cfg.num_experts % tp == 0
            and seq_len % tp == 0):
        return set()
    return {n for n in names if ".moe." in n and not n.endswith("router")}


# ---------------------------------------------------------------------------
# The train plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainPlan:
    """A train step and its tables. Call it (``plan(state, batch)``) for
    one step. On a mesh: ``param_specs``, ``moment_specs``,
    ``compute_specs`` (what the compute model holds: whole, or an
    expert's shard over "model") and ``batch_specs`` by name; ``model``
    is the compute model once a state is bound (`init_state`)."""

    cfg: ModelConfig
    shape: Optional[ShapeConfig]
    mesh: Any
    step_fn: Callable
    description: str
    param_shapes: Dict[str, Tuple[torch.Size, torch.dtype]] = None
    param_specs: Dict[str, Any] = None
    moment_specs: Dict[str, Any] = None
    compute_specs: Dict[str, Any] = None
    batch_specs: Dict[str, Any] = None
    model: Optional[CausalLM] = None

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, dict]:
        return self.step_fn(state, batch)

    # -- on a mesh -----------------------------------------------------
    def shardings(self, specs: Dict[str, Any]) -> Dict[str, NamedSharding]:
        return {n: NamedSharding(self.mesh, s) for n, s in specs.items()}

    def state_shardings(self) -> TrainState:
        """The state's `NamedSharding` pytree (for checkpoints)."""
        moments = self.shardings(self.moment_specs)
        return TrainState(params=self.shardings(self.param_specs),
                          opt=AdamWState(
                              step=NamedSharding(self.mesh, P()),
                              m=moments, v=dict(moments)))

    def init_state(self, model: CausalLM) -> TrainState:
        """The state of ``model`` (whole, on the rank's device: every rank
        builds the same one, `init_model` from one seed) at step 0: the
        rank's parameter blocks and zero moment blocks. ``model`` becomes
        the plan's compute model (an expert-parallel MoE's experts cut to
        the rank's shard, in place)."""
        if self.param_specs is None:
            return init_train_state(model)
        ps = self.shardings(self.param_specs)
        ms = self.shardings(self.moment_specs)
        full = dict(model.named_parameters())
        with torch.no_grad():
            params = {n: ps[n].block(p).clone() for n, p in full.items()}
        zeros = lambda: {n: torch.zeros(  # noqa: E731
            ms[n].shard_shape(p.shape), dtype=torch.float32,
            device=p.device) for n, p in full.items()}
        moments = (zeros(), zeros())
        if any(e == "model" for s in self.compute_specs.values() for e in s):
            from repro_torch.models import moe as moe_lib

            moe_lib.shard_model(model, self.cfg, self.mesh)
        self.model = model
        dev = next(iter(params.values())).device
        return TrainState(params=params, opt=AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=moments[0], v=moments[1]))

    def per_chip_argument_bytes(self) -> int:
        """Resident bytes per rank of the step's inputs (parameters,
        AdamW state, batch), from the axis sizes alone, counted on the
        reference's stacked leaves exactly as its
        ``CellPlan.per_chip_argument_bytes`` counts them."""
        leaves, pspec, mspec = _leaf_specs(self.cfg, self.mesh, True)
        return self._state_bytes(
            (leaf.shape, pspec[k], mspec[k], leaf.dtype)
            for k, leaf in leaves.items())

    def resident_bytes(self) -> int:
        """Bytes per rank of the port's own blocks (per-layer parameters,
        the moments, the step and the batch rows): equal to
        `per_chip_argument_bytes` where no spec shards a stacked layer
        dimension, more where one does (ROADMAP C)."""
        return self._state_bytes(
            (shape, self.param_specs[n], self.moment_specs[n], dtype)
            for n, (shape, dtype) in self.param_shapes.items())

    def _state_bytes(self, leaves) -> int:
        """Block bytes of ``(shape, param spec, moment spec, dtype)``
        leaves (the parameter and two float32 moments each), the int32
        step and the batch."""
        cfg = self.cfg
        size = lambda shape, spec, itemsize: math.prod(  # noqa: E731
            NamedSharding(self.mesh, spec).shard_shape(shape)) * itemsize
        total = 4
        for shape, pspec, mspec, dtype in leaves:
            total += size(shape, pspec, dtype.itemsize)
            total += 2 * size(shape, mspec, 4)
        B, T = self.shape.global_batch, self.shape.seq_len
        for name, spec in self.batch_specs.items():
            if name == "enc_emb":
                total += size((B, cfg.encoder_seq_len, cfg.d_model), spec,
                              dtype_of(cfg.compute_dtype).itemsize)
            else:
                total += size((B, T), spec, 4)
        return total


def _reduce_grad(g: torch.Tensor, compute: NamedSharding,
                 moment: NamedSharding, batch: tuple) -> torch.Tensor:
    """The rank's moment block of the whole gradient, float32, from its
    compute model's gradient ``g`` (under ``compute``): cut to the block
    along the axes the moment spec adds, summed over the batch axes (a
    reduce-scatter along a dimension the block splits over one, an
    all-reduce over the others)."""
    mesh = moment.mesh
    t = g.float()
    done = set()
    for dim, (ce, me) in enumerate(zip(compute._entries(g.dim()),
                                       moment._entries(g.dim()))):
        for a in _extra_axes(ce, me):
            if mesh.shape[a] == 1:
                continue
            if a in batch:
                t = psum_scatter(t, a, scatter_dimension=dim, tiled=True)
                done.add(a)
            else:
                size = t.shape[dim] // mesh.shape[a]
                t = t.narrow(dim, mesh.coords[a] * size, size)
    rest = tuple(a for a in batch if a not in done and mesh.shape[a] > 1)
    if rest:
        t = psum(t, rest)
    return t.contiguous()


def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[ShapeConfig] = None,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    total_steps: int = 100_000, warmup_steps: int = 2000,
                    sequence_parallel: bool = True) -> TrainPlan:
    """The train plan; ``plan(state, batch) -> (state, metrics)`` is one
    AdamW step. ``metrics``: ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``clip_scale``, device scalars.

    One device (``mesh`` None or of one rank): ``state`` is
    `init_train_state(model)`, ``batch`` the whole batch on the model's
    device (``tokens``, ``labels`` and an encoder-decoder's ``enc_emb``).

    A mesh (a `Mesh` of the ranks; an `AbstractMesh` for the tables
    alone): ``shape`` gives the global batch and the sequence length,
    ``state`` is ``plan.init_state(model)``, ``batch`` the rank's rows
    (``shape.global_batch`` split over the batch axes, row-major), and
    the step runs on every rank at once (module docstring).
    ``sequence_parallel`` is the reference's residual-stream layout hint
    (`sharding.residual_spec`), which the port's replicated residual
    stream has no use for."""
    del sequence_parallel
    if mesh is None or mesh.size == 1:
        return _one_device_plan(cfg, shape, opt_cfg, total_steps,
                                warmup_steps)
    if shape is None:
        raise ValueError("a train step on a mesh needs its shape (global "
                         "batch and sequence length)")
    b_axis = batch_axes(mesh)
    dsize = _data_size(mesh)
    if shape.global_batch % dsize:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"over {dsize} data ranks")
    shapes, pspecs, _, opt_specs = param_and_state_specs(cfg, mesh,
                                                         for_train=True)
    ep = _ep_names(cfg, mesh, shape.seq_len, shapes)
    if (cfg.num_experts and not ep and dsize > 1
            and mesh.shape.get("model", 1) > 1):
        raise NotImplementedError(
            f"{cfg.name}: its MoE layers take the global dispatch at T = "
            f"{shape.seq_len} on this mesh, whose capacity and aux loss "
            "span the global batch; split over 'data' they would not. "
            "Train it where the experts shard over 'model' (E and T "
            "multiples of the 'model' size) or on one data rank")
    cspecs = {n: P(*[e if (n in ep and e == "model") else None
                     for e in pspecs[n]]) for n in shapes}
    batch = tuple(a for a in b_axis if a in mesh.shape)
    plan = TrainPlan(cfg=cfg, shape=shape, mesh=mesh, step_fn=None,
                     description=f"train_step {cfg.name} x {shape.name}",
                     param_shapes=shapes, param_specs=pspecs,
                     moment_specs=opt_specs.m, compute_specs=cspecs,
                     batch_specs=shard_lib.train_batch_specs(cfg, b_axis))

    def step(state: TrainState, batch_rows) -> Tuple[TrainState, dict]:
        model = plan.model
        if model is None:
            raise RuntimeError("the plan has no compute model: make the "
                               "state with plan.init_state(model) on every "
                               "rank of the mesh first")
        ps, ms = plan.shardings(pspecs), plan.shardings(opt_specs.m)
        cs = plan.shardings(cspecs)
        with mesh:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(coarsen_block(state.params[n], ps[n], cs[n]))
            loss, metrics, grads = loss_and_grads(model, cfg, batch_rows)
            blocks = {}
            for n in list(grads):
                blocks[n] = _reduce_grad(grads.pop(n), cs[n], ms[n], batch)
            lr_scale = warmup_cosine(state.opt.step,
                                     warmup_steps=warmup_steps,
                                     total_steps=total_steps)
            _, opt, opt_metrics = adamw_update_sharded(
                opt_cfg, state.params, blocks, state.opt, lr_scale,
                param_shardings=ps, moment_shardings=ms)
        return TrainState(params=state.params, opt=opt), dict(
            metrics, loss=loss, **opt_metrics)

    plan.step_fn = step
    return plan


def _one_device_plan(cfg, shape, opt_cfg, total_steps, warmup_steps
                     ) -> TrainPlan:
    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        model = state.params
        loss, metrics, grads = loss_and_grads(model, cfg, batch)
        lr_scale = warmup_cosine(state.opt.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        _, opt, opt_metrics = adamw_update(
            opt_cfg, dict(model.named_parameters()), grads, state.opt,
            lr_scale)
        return TrainState(params=model, opt=opt), dict(
            metrics, loss=loss, **opt_metrics)

    name = shape.name if shape is not None else "one device"
    return TrainPlan(cfg=cfg, shape=shape, mesh=None, step_fn=step,
                     description=f"train_step {cfg.name} x {name}")


def batch_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The rank's rows of a global ``batch`` (arrays or tensors, rows
    first): block ``i`` of `launch.mesh.batch_shard`'s ``i``."""
    n, idx = batch_shard(mesh)
    return {k: v[idx * (v.shape[0] // n):(idx + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


__all__ = ["TrainState", "TrainPlan", "init_train_state", "loss_and_grads",
           "param_and_state_specs", "init_adamw_abstract", "make_train_step",
           "batch_rows", "AdamWConfig"]
