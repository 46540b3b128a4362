"""The cell plans and their sharding tables: the JAX package's
``repro.launch.steps``. `make_cell_plan(cfg, mesh, shape)` gives the plan
of one (arch x shape x mesh) cell by the shape's kind: `make_train_step`,
`make_prefill_step` or `make_decode_step`. Each is a `CellPlan`, whose
`per_chip_argument_bytes` is the reference's resident bytes per chip of
the step's inputs, from the axis sizes alone (an `AbstractMesh` will
do), and which `launch.cost` traces for one rank on ``meta`` tensors.

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
* a step all_gathers each parameter into the rank's compute model and
  runs the forward and backward on the rank's rows of the batch;
* each gradient is cut to the rank's moment block and summed over the
  batch axes (a reduce-scatter where the block splits over "data", an
  all-reduce where it does not), and `optim.adamw_update_sharded`
  updates the blocks.

The compute model of a dense, hybrid or encoder-decoder config is
tensor-parallel (`sharding.tensor_parallel`): each rank holds the
reference's "model" block of every parameter (its specs with the batch
axes taken out, `sharding.tp_compute_specs`), so a step gathers a
parameter over the batch axes only (an FSDP-widened one over "data"),
the layers run Megatron's tensor parallelism as the reference's GSPMD
does (with the residual stream split along T where
``sequence_parallel`` asks), and a gradient is already the rank's
"model" block. The SSM's ``in_proj`` is the one weight whose compute
block is not its resting block (`sharding.split_halves`): it is
exchanged over "model" into the compute model, and its gradient back
(`CellPlan._load_params`, `CellPlan._reduce_grads`). The other families
(MoE, xLSTM) hold every parameter whole on every rank, except an
expert-parallel MoE's experts, which stay the rank's shard, and run the
mixers' expert- and sequence-parallel paths: their dense layers run
replicated over "model" (ROADMAP C). An MoE that takes the global
dispatch routes the global batch (`models.moe.route`).

The prefill and decode plans (`ServePlan`) lay out the compute model in
the same way on every rank of a mesh, the rank's rows of the batch
split over the batch axes. A tensor-parallel decode step reads and
writes the rank's cache blocks in place (its kv heads, its block of the
caches' sequence, or the whole cache where neither splits: the
reference's cache specs: a hybrid's SSM state by its ``d_inner``
channels); the other families gather each cache block over the axes
besides the batch's, use it, and write it back. A bound serve plan
loads its compute model once: its steps move no parameter.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import (AbstractMesh, NamedSharding, P,
                                     _extra_axes, coarsen_block, map_specs,
                                     psum, psum_scatter, refine_block,
                                     tree_map)
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
                   batch: Dict[str, torch.Tensor], *,
                   sequence_parallel: bool = False
                   ) -> Tuple[torch.Tensor, dict, Dict[str, torch.Tensor]]:
    """``value_and_grad(train_loss)``: (loss, ``{"ce", "aux"}``, the
    gradient of every named parameter). A parameter the loss does not
    reach (a cross-attention's QKV bias, which the reference's
    cross-attention ignores too) gets zeros, as under JAX."""
    params = dict(model.named_parameters())
    loss, metrics = train_loss(model, cfg, batch,
                               sequence_parallel=sequence_parallel)
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


def _compute_specs(pspecs: Dict[str, Any], ep: set) -> Dict[str, Any]:
    """What the compute model holds of each parameter: whole, but for the
    expert-parallel experts ``ep``, cut over "model" as at rest."""
    return {n: P(*[e if (n in ep and e == "model") else None for e in s])
            for n, s in pspecs.items()}


def _ep_names(cfg: ModelConfig, mesh, seq_len: int, names) -> set:
    """Parameters the compute model keeps as the rank's shard over
    "model": an expert-parallel MoE's experts (`moe._moe_layer_ep`)."""
    tp = mesh.shape.get("model", 1)
    if not (cfg.num_experts and tp > 1 and cfg.num_experts % tp == 0
            and seq_len % tp == 0):
        return set()
    return {n for n in names if ".moe." in n and not n.endswith("router")}


def _plan_compute_specs(cfg: ModelConfig, mesh, pspecs, ep: set,
                        kind: str) -> Tuple[Dict[str, Any], bool]:
    """(the compute specs, whether tensor-parallel) of a plan of ``kind``
    on ``mesh``: the "model" blocks for the families that split over it
    (`sharding.tensor_parallel`), else `_compute_specs`."""
    if shard_lib.tensor_parallel(cfg, mesh, kind):
        return shard_lib.tp_compute_specs(cfg, mesh, pspecs), True
    return _compute_specs(pspecs, ep), False


# ---------------------------------------------------------------------------
# Cell plans
# ---------------------------------------------------------------------------

def _one_rank(mesh):
    """``mesh``, or for one device (None) a mesh of one rank."""
    return AbstractMesh((1, 1), ("data", "model")) if mesh is None else mesh


def _block_bytes(mesh, leaves) -> int:
    """Bytes of one rank's blocks of ``(shape, spec, itemsize)`` leaves
    (a dimension that does not divide rounds up, as GSPMD pads); one
    device (``mesh`` None) holds them whole."""
    mesh = _one_rank(mesh)
    return sum(math.prod(NamedSharding(mesh, spec).shard_shape(shape))
               * itemsize for shape, spec, itemsize in leaves)


@dataclasses.dataclass
class CellPlan:
    """One (arch x shape x mesh) cell: its step and its tables. Call it
    for one step (``plan(*args)``); `per_chip_argument_bytes` is the
    reference's count of the step's inputs per chip, from the axis sizes
    alone (an `AbstractMesh` will do). ``kind`` is the shape's ("train",
    "prefill" or "decode"); ``model`` the compute model once one is bound
    (`bind`, `TrainPlan.init_state`); ``param_specs`` and
    ``compute_specs`` (what the compute model holds: the "model" blocks
    where ``tensor_parallel``, else whole or an expert-parallel MoE's
    expert shard over "model") by name, on a mesh."""

    cfg: ModelConfig
    shape: Optional[ShapeConfig]
    mesh: Any
    step_fn: Callable
    description: str
    kind: str = "train"
    param_shapes: Dict[str, Tuple[torch.Size, torch.dtype]] = None
    param_specs: Dict[str, Any] = None
    compute_specs: Dict[str, Any] = None
    model: Optional[CausalLM] = None
    tensor_parallel: bool = False

    def __call__(self, *args, **kwargs):
        return self.step_fn(*args, **kwargs)

    def shardings(self, specs: Dict[str, Any]) -> Dict[str, NamedSharding]:
        return {n: NamedSharding(self.mesh, s) for n, s in specs.items()}

    def argument_leaves(self):
        """The step's inputs as the reference lays them out: ``(global
        shape, spec, itemsize)`` per leaf."""
        raise NotImplementedError

    def per_chip_argument_bytes(self) -> int:
        """Exact resident bytes per chip of the step's inputs (weights,
        optimizer state, caches, batch), as the reference's
        ``CellPlan.per_chip_argument_bytes`` counts them."""
        return _block_bytes(self.mesh, self.argument_leaves())

    def compute_param_bytes(self) -> int:
        """Bytes per rank of the compute model's parameters, as the plan's
        compute specs cut them (the whole model on one device)."""
        specs = self.compute_specs or {}
        shapes = self.param_shapes or shard_lib.param_shapes(self.cfg)
        return _block_bytes(self.mesh, [
            (shape, specs.get(n, P()), dtype.itemsize)
            for n, (shape, dtype) in shapes.items()])

    def _use_model(self, model: CausalLM) -> None:
        """Make ``model`` (whole, on the rank's device) the compute model:
        its "model" blocks where the plan is tensor-parallel, else whole
        with an expert-parallel MoE's experts cut to the rank's shard."""
        if self.tensor_parallel:
            shard_lib.shard_tensor_parallel(model, self.cfg, self.mesh,
                                            self.compute_specs)
        elif any(e == "model" for s in self.compute_specs.values()
                 for e in s):
            from repro_torch.models import moe as moe_lib

            moe_lib.shard_model(model, self.cfg, self.mesh)
        self.model = model

    def _halves(self, name: str) -> bool:
        """Whether the compute model holds parameter ``name`` as its block
        of each half while it rests in one contiguous block
        (`sharding.split_halves`): its two layouts differ by an exchange
        over "model"."""
        return self.tensor_parallel and shard_lib.split_halves(name)

    def _blocks_of(self, model: CausalLM) -> Dict[str, torch.Tensor]:
        """The rank's parameter blocks (copies) of ``model``: whole, or a
        tensor-parallel compute model already cut to its "model" blocks."""
        ps = self.shardings(self.param_specs)
        cs = self.shardings(self.compute_specs)
        cut = getattr(model, "tp_axis", None) is not None
        out = {}
        with torch.no_grad():
            for n, p in model.named_parameters():
                if not cut:
                    out[n] = ps[n].block(p).clone()
                    continue
                if self._halves(n):
                    p = shard_lib.from_halves(p, self.mesh)
                out[n] = refine_block(p, cs[n], ps[n]).clone()
        return out

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """The compute model's parameters from the rank's blocks
        (all_gathers over the axes its specs cut; a `_halves` weight then
        exchanged over "model")."""
        ps, cs = self.shardings(self.param_specs), self.shardings(
            self.compute_specs)
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                block = coarsen_block(params[n], ps[n], cs[n])
                if self._halves(n):
                    block = shard_lib.to_halves(block, self.mesh)
                p.copy_(block)

    def _reduce_grads(self, grads: Dict[str, torch.Tensor],
                      moment_specs: Dict[str, Any], batch: tuple
                      ) -> Dict[str, torch.Tensor]:
        """The rank's moment blocks of the whole gradients from its
        compute model's (`_reduce_grad`), a `_halves` weight's gradient
        first taken back to its resting block over "model"."""
        cs, ms = self.shardings(self.compute_specs), self.shardings(
            moment_specs)
        blocks = {}
        for n in list(grads):
            g = grads.pop(n)
            if self._halves(n):
                g = shard_lib.from_halves(g, self.mesh)
            blocks[n] = _reduce_grad(g, cs[n], ms[n], batch)
        return blocks


@dataclasses.dataclass
class TrainPlan(CellPlan):
    """A train step and its tables. Call it (``plan(state, batch)``) for
    one step. On a mesh: ``moment_specs`` and ``batch_specs`` by name too;
    ``model`` is the compute model once a state is bound
    (`init_state`)."""

    moment_specs: Dict[str, Any] = None
    batch_specs: Dict[str, Any] = None

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
        ms = self.shardings(self.moment_specs)
        params = self._blocks_of(model)
        zeros = lambda: {n: torch.zeros(  # noqa: E731
            ms[n].shard_shape(self.param_shapes[n][0]), dtype=torch.float32,
            device=p.device) for n, p in params.items()}
        moments = (zeros(), zeros())
        self._use_model(model)
        dev = next(iter(params.values())).device
        return TrainState(params=params, opt=AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=moments[0], v=moments[1]))

    def argument_leaves(self):
        """The parameters and both float32 moments on the reference's
        stacked leaves, the int32 step and the batch."""
        if self.shape is None:
            raise ValueError("the plan has no shape: its batch is unknown")
        leaves, pspec, mspec = _leaf_specs(self.cfg, _one_rank(self.mesh),
                                           True)
        return self._state_leaves(
            (leaf.shape, pspec[k], mspec[k], leaf.dtype)
            for k, leaf in leaves.items())

    def resident_bytes(self) -> int:
        """Bytes per rank of the port's own blocks (per-layer parameters,
        the moments, the step and the batch rows): equal to
        `per_chip_argument_bytes` where no spec shards a stacked layer
        dimension, more where one does (ROADMAP C)."""
        return _block_bytes(self.mesh, self._state_leaves(
            (shape, self.param_specs[n], self.moment_specs[n], dtype)
            for n, (shape, dtype) in self.param_shapes.items()))

    def _state_leaves(self, leaves):
        """``(shape, spec, itemsize)`` of ``(shape, param spec, moment
        spec, dtype)`` leaves (the parameter and two float32 moments
        each), the int32 step and the batch."""
        out = [((), P(), 4)]
        for shape, pspec, mspec, dtype in leaves:
            out += [(shape, pspec, dtype.itemsize), (shape, mspec, 4),
                    (shape, mspec, 4)]
        cfg = self.cfg
        B, T = self.shape.global_batch, self.shape.seq_len
        for name, spec in self.batch_specs.items():
            if name == "enc_emb":
                out.append(((B, cfg.encoder_seq_len, cfg.d_model), spec,
                            dtype_of(cfg.compute_dtype).itemsize))
            else:
                out.append(((B, T), spec, 4))
        return out


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
    ``sequence_parallel``: as the reference's ``residual_spec``, a
    tensor-parallel model splits its residual stream along T over
    "model" where T divides (`sharding.residual_spec`; an encoder's
    along its own sequence); the other families keep it replicated."""
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
    cspecs, tp = _plan_compute_specs(cfg, mesh, pspecs, ep, "train")
    batch = tuple(a for a in b_axis if a in mesh.shape)
    plan = TrainPlan(cfg=cfg, shape=shape, mesh=mesh, step_fn=None,
                     description=f"train_step {cfg.name} x {shape.name}",
                     param_shapes=shapes, param_specs=pspecs,
                     compute_specs=cspecs, moment_specs=opt_specs.m,
                     batch_specs=shard_lib.train_batch_specs(cfg, b_axis),
                     tensor_parallel=tp)

    def step(state: TrainState, batch_rows) -> Tuple[TrainState, dict]:
        model = plan.model
        if model is None:
            raise RuntimeError("the plan has no compute model: make the "
                               "state with plan.init_state(model) on every "
                               "rank of the mesh first")
        ps, ms = plan.shardings(pspecs), plan.shardings(opt_specs.m)
        with mesh:
            plan._load_params(state.params)
            loss, metrics, grads = loss_and_grads(
                model, cfg, batch_rows, sequence_parallel=sequence_parallel)
            blocks = plan._reduce_grads(grads, opt_specs.m, batch)
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
                     description=f"train_step {cfg.name} x {name}",
                     batch_specs=shard_lib.train_batch_specs(cfg))


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _cache_shapes_and_specs(cfg: ModelConfig, B: int, S: int, mesh):
    """The decode caches of a batch of ``B`` at capacity ``S`` as ``meta``
    tensors (`models.init_caches`: nothing allocated) and their specs,
    by the reference's decode rules: the batch over "data" where it
    divides, the KV heads over "model" where they divide it and
    otherwise, for a cache of at least 16 positions, the cache's sequence
    over "model" (which keeps the largest caches resident); adapted to a
    multi-pod mesh."""
    from repro_torch.models import cache_specs, init_caches

    shapes = init_caches(cfg, B, S, device="meta")
    dsize = mesh.shape["data"]
    b_axis = ("data",) if B % dsize == 0 and B >= dsize else None
    specs = cache_specs(cfg, batch_spec=b_axis)
    if not cfg.shard_kv_heads:
        def fix_kv(spec, like):
            # KV caches are rank-5 here ([layers, B, Hkv, S, Dh]).
            if like.dim() == 5 and like.shape[3] == S and S >= 16:
                entries = list(spec) + [None] * (5 - len(spec))
                if entries[2] == "model":
                    entries[2] = None
                entries[3] = "model"
                return P(*entries)
            return spec
        specs = map_specs(fix_kv, specs, shapes)
    return shapes, shard_lib.adapt_specs_for_mesh(specs, mesh)


def _row_spec(spec) -> Any:
    """``spec`` with only its batch axes ("pod", "data") kept: a block's
    rows, every other dimension whole."""
    return P(*[e if e is not None and set(
        (e,) if isinstance(e, str) else e) <= {"pod", "data"} else None
        for e in spec])


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclasses.dataclass
class ServePlan(CellPlan):
    """A prefill or decode step and its tables.

    ``plan.bind(model)`` gives the rank's parameter blocks (on one
    device, the model's own parameters) and makes ``model`` the compute
    model; ``plan.cache_blocks(caches)`` the rank's blocks of whole
    caches; ``plan.rows(t)`` the rank's rows of a whole batch tensor.
    Then ``plan(params, tokens[, enc_emb])`` is one prefill (the last
    position's logits of the rank's rows) and ``plan(params, caches,
    tokens, pos[, memory])`` one decode step (the rank's rows' logits and
    its cache blocks, written in place).

    On a mesh the step runs on every rank at once, with the compute model
    of the train step's layout: a dense, hybrid or encoder-decoder
    config's "model" blocks
    (``tensor_parallel``; prefill sequence-parallel where T divides), a
    decode step reading and writing the rank's cache blocks in place
    (`models.attention.caches_split_along_sequence` where the caches'
    sequence splits over "model") and the logits gathered over the
    vocabulary; the other families' parameters all_gathered whole (an
    expert-parallel MoE's experts into the rank's shard), the rank
    running the model on its rows, and a decode step all_gathering each
    cache block over the axes besides the batch's (the KV heads, or the
    sequence where they do not divide "model"; an SSM's or xLSTM's
    width), running on the rows' whole caches and writing the rank's
    block back. A decode batch that does not divide "data" is whole on
    every rank, and an MoE's global dispatch is told so
    (`moe.rows_split_over`). ``bind`` also takes a model that a
    tensor-parallel plan on the same mesh has bound already."""

    arg_leaves: list = None
    cache_specs: Any = None
    row_spec: Any = None
    #: The parameter blocks the compute model holds now, each with its
    #: version counter (`_load_params`).
    loaded: Any = dataclasses.field(default=None, repr=False)

    def argument_leaves(self):
        return self.arg_leaves

    def bind(self, model: CausalLM) -> Dict[str, torch.Tensor]:
        if self.mesh is None:
            self.model = model
            return dict(model.named_parameters())
        params = self._blocks_of(model)
        self._use_model(model)
        self.loaded = _versions(params)
        return params

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """As `CellPlan._load_params`, only where ``params`` are not the
        blocks the compute model holds already: other tensors, or the
        same written since. A serve step changes no parameter, so a bound
        plan's steps move none (a `_halves` weight's exchange included)."""
        now = _versions(params)
        if self.loaded is not None and len(now) == len(self.loaded) and all(
                a is b and va == vb for (a, va), (b, vb) in zip(
                    now, self.loaded)):
            return
        super()._load_params(params)
        self.loaded = now

    def cache_blocks(self, caches):
        if self.mesh is None:
            return caches
        return tree_map(lambda t, spec: NamedSharding(self.mesh, spec)
                        .block(t).clone(), caches, self.cache_specs,
                        is_leaf=_is_tensor)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        return NamedSharding(self.mesh, P(self.row_spec)).block(t)


def _versions(params: Dict[str, torch.Tensor]) -> list:
    """Each tensor of ``params`` with its version counter (bumped by every
    in-place write)."""
    return [(t, t._version) for t in params.values()]


def _serve_tables(cfg: ModelConfig, mesh, shape: ShapeConfig, kind: str):
    """(the parameter leaves as the reference lays them out, the port's
    parameter specs and compute specs) of a serve step on ``mesh``."""
    shapes, pspecs, _, _ = param_and_state_specs(cfg, _one_rank(mesh),
                                                 for_train=False)
    leaves, lspec, _ = _leaf_specs(cfg, _one_rank(mesh), False)
    arg_leaves = [(leaf.shape, lspec[k], leaf.dtype.itemsize)
                  for k, leaf in leaves.items()]
    T = shape.seq_len if kind == "prefill" else 1
    ep = set() if mesh is None else _ep_names(cfg, mesh, T, shapes)
    cspecs, tp = _plan_compute_specs(cfg, mesh, pspecs, ep, kind)
    return arg_leaves, pspecs, cspecs, shapes, tp


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig
                      ) -> ServePlan:
    """The prefill plan of the cell (`ServePlan`): the prompt ``tokens
    [B, T]`` split over the batch axes."""
    from repro_torch.models import prefill

    if mesh is not None and mesh.size == 1:
        mesh = None
    arg_leaves, pspecs, cspecs, shapes, tp = _serve_tables(cfg, mesh, shape,
                                                           "prefill")
    b_axis = batch_axes(_one_rank(mesh))
    B, T = shape.global_batch, shape.seq_len
    arg_leaves.append(((B, T), P(b_axis, None), 4))
    if cfg.encoder_layers:
        arg_leaves.append(((B, cfg.encoder_seq_len, cfg.d_model),
                           P(b_axis, None, None),
                           dtype_of(cfg.compute_dtype).itemsize))
    plan = ServePlan(cfg=cfg, shape=shape, mesh=mesh, step_fn=None,
                     description=f"prefill {cfg.name} x {shape.name}",
                     kind="prefill", param_shapes=shapes,
                     param_specs=pspecs, compute_specs=cspecs,
                     arg_leaves=arg_leaves, row_spec=b_axis,
                     tensor_parallel=tp)

    def step(params, tokens, enc_emb=None):
        if mesh is None:
            return prefill(plan.model, cfg, tokens, enc_emb)
        with mesh:
            plan._load_params(params)
            # The reference's prefill residual spec: split along T over
            # "model" where T divides (a tensor-parallel model only).
            return prefill(plan.model, cfg, tokens, enc_emb,
                           sequence_parallel=True)

    plan.step_fn = step
    return plan


def make_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig
                     ) -> ServePlan:
    """The decode plan of the cell (`ServePlan`): one token per sequence
    of ``B`` against caches of capacity ``S`` (the shape's global batch
    and sequence length). The batch splits over "data" where it divides
    (and the caches' over "pod" too on a multi-pod mesh, where the
    reference's tokens split over "data" alone: the port's step takes
    the tokens of its caches' rows)."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import decode_step
    from repro_torch.models import moe as moe_lib

    if mesh is not None and mesh.size == 1:
        mesh = None
    arg_leaves, pspecs, cspecs, shapes, tp = _serve_tables(cfg, mesh, shape,
                                                           "decode")
    m = _one_rank(mesh)
    B, S = shape.global_batch, shape.seq_len
    cache_shapes, cache_specs = _cache_shapes_and_specs(cfg, B, S, m)
    tree_map(lambda t, spec: arg_leaves.append(
        (tuple(t.shape), spec, t.element_size())), cache_shapes,
        cache_specs, is_leaf=_is_tensor)
    dsize = m.shape["data"]
    tok_b = ("data",) if B % dsize == 0 and B >= dsize else None
    arg_leaves += [((B, 1), P(tok_b, None), 4), ((), P(), 4)]
    if cfg.encoder_layers:
        arg_leaves.append(((B, cfg.encoder_seq_len, cfg.d_model),
                           P(tok_b, None, None),
                           dtype_of(cfg.compute_dtype).itemsize))
    row = None if tok_b is None else shard_lib.adapt_specs_for_mesh(
        P(tok_b), m)[0]
    # The axes the rows split over, for an MoE's global dispatch: none
    # where the batch does not divide "data" and every rank holds it.
    split = () if row is None else (row,) if isinstance(row, str) else row
    plan = ServePlan(cfg=cfg, shape=shape, mesh=mesh, step_fn=None,
                     description=f"decode {cfg.name} x {shape.name}",
                     kind="decode", param_shapes=shapes,
                     param_specs=pspecs, compute_specs=cspecs,
                     arg_leaves=arg_leaves, cache_specs=cache_specs,
                     row_spec=row, tensor_parallel=tp)
    # Where the reference splits the kv caches' sequence over "model"
    # (`_cache_shapes_and_specs`), the rank's cache blocks are its rows.
    seq_split = (tp and not shard_lib.kv_heads_split(cfg, m) and S >= 16)

    def step(params, caches, tokens, pos, memory=None):
        if mesh is None:
            return decode_step(plan.model, cfg, caches, tokens, pos,
                               memory=memory)
        if tp:
            with mesh, contextlib.ExitStack() as stack:
                if seq_split:
                    stack.enter_context(
                        attn_lib.caches_split_along_sequence("model", S))
                plan._load_params(params)
                logits, new = decode_step(plan.model, cfg, caches, tokens,
                                          pos, memory=memory)
            # The blocks were written in place; the lengths advance.
            with torch.no_grad():
                for t, n in zip(_leaves(caches), _leaves(new)):
                    if n is not t:
                        t.copy_(n)
            return logits, caches
        blocks = {id(t): NamedSharding(mesh, spec) for t, spec in zip(
            _leaves(caches), _leaves(cache_specs))}
        with mesh, moe_lib.rows_split_over(split):
            plan._load_params(params)
            whole = tree_map(lambda t: coarsen_block(
                t, blocks[id(t)], NamedSharding(mesh, _row_spec(
                    blocks[id(t)].spec))), caches, is_leaf=_is_tensor)
            logits, new = decode_step(plan.model, cfg, whole, tokens, pos,
                                      memory=memory)
            with torch.no_grad():
                for t, n in zip(_leaves(caches), _leaves(new)):
                    sh = blocks[id(t)]
                    t.copy_(refine_block(n, NamedSharding(
                        mesh, _row_spec(sh.spec)), sh))
        return logits, caches

    plan.step_fn = step
    return plan


def _leaves(tree) -> list:
    """The leaves (tensors or specs) of a cache tree, in order."""
    out = []
    tree_map(out.append, tree,
             is_leaf=lambda x: _is_tensor(x) or isinstance(x, P))
    return out


def make_cell_plan(cfg: ModelConfig, mesh, shape: ShapeConfig) -> CellPlan:
    """The cell's plan by the shape's kind: `make_train_step`,
    `make_prefill_step` or `make_decode_step`."""
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    if shape.kind == "decode":
        return make_decode_step(cfg, mesh, shape)
    raise ValueError(shape.kind)


def batch_rows(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The rank's rows of a global ``batch`` (arrays or tensors, rows
    first): block ``i`` of `launch.mesh.batch_shard`'s ``i``."""
    n, idx = batch_shard(mesh)
    return {k: v[idx * (v.shape[0] // n):(idx + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


__all__ = ["TrainState", "CellPlan", "TrainPlan", "ServePlan",
           "init_train_state", "loss_and_grads", "param_and_state_specs",
           "init_adamw_abstract", "make_train_step", "make_prefill_step",
           "make_decode_step", "make_cell_plan", "batch_rows",
           "AdamWConfig"]
