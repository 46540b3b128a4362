"""The cost of one rank's step, counted from what the port runs: the
counterpart of the JAX package's ``repro.launch.hlo_analysis``.

The port has no compiled HLO to read, so `Counter` watches the step run
(a ``TorchDispatchMode``), on ``meta`` tensors for a cell of any size
(nothing is allocated or computed) or on real ones:

* FLOPs: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions), by ``torch.utils.flop_counter``'s formulas; elementwise
  work is not counted, as in the reference's model;
* HBM bytes: each operation's operand bytes plus its output bytes (an
  eager operation is one launch: the reference's "each fusion reads its
  inputs once and writes its outputs once"), except that a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) moves twice its
  output, a scatter or an indexed update (``index_put_``, ``index_copy_``,
  ``index_add_``, ``scatter``, ``scatter_add``) twice its update, and a
  ``copy_`` twice its source, as the reference counts slices and
  dynamic updates; views and allocations move nothing;
* collective bytes by kind, each collective's output bytes, reported by
  `repro_torch.distributed` (`repro_torch.counting.collective`); a
  collective's operand and output bytes count as HBM bytes too;
* the hand-written kernels, which the dispatcher does not see (they are
  called through ``ctypes``): each declares one call's FLOPs and bytes
  by its formula (`kernels.work`, `repro_torch.counting.kernel_call`),
  and the operations inside its region, the plain version's among them,
  are not counted. So a step counts the same whether the kernels run on
  the card or the plain versions on the CPU or on ``meta``.

`count_cell` traces one rank (the first) of a `launch.steps` plan on an
`AbstractMesh` (or one device) on ``meta`` tensors.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import counting

aten = torch.ops.aten

#: The reference's collective kinds.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: Operations that move no data: allocations and metadata.
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default, aten._unsafe_view.default,
               aten.lift_fresh.default, aten._local_scalar_dense.default}
#: Sparse reads: only the gathered rows move (twice the output).
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.gather.default, aten.embedding.default}
#: Indexed updates: the update moves (twice), which argument it is.
_UPDATES = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten.index_copy_.default: 3, aten.index_copy.default: 3,
            aten.index_add_.default: 3, aten.index_add.default: 3,
            aten.scatter_.src: 3, aten.scatter.src: 3,
            aten.scatter_add_.default: 3, aten.scatter_add.default: 3,
            aten.copy_.default: 1}


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class Counter(TorchDispatchMode):
    """Counts the FLOPs, HBM bytes and collective bytes of what runs
    under it (module docstring). ``flops``, ``hbm_bytes``,
    ``collective_bytes`` (by kind), ``kernels`` (calls by name), and per
    operation ``by_op[(name, shapes)] = [calls, flops, bytes]`` for the
    top-op tables. On ``meta`` tensors a long time loop is counted by
    its trip count (`repro_torch.counting.LOOP_STEPS`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes = {k: 0.0 for k in COLLECTIVES}
        self.kernels: Dict[str, int] = collections.Counter()
        self.by_op: Dict[Tuple[str, str], list] = {}
        self._registry = _flop_registry()

    # -- what the port reports --------------------------------------------
    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.kernels[name] += counting.scale()
        self._add(f"kernel {name}", "", flops, nbytes)

    def collective(self, kind: str, out_bytes: int, in_bytes: int) -> None:
        self.collective_bytes[kind] += out_bytes * counting.scale()
        self._add(f"collective {kind}", "", 0.0, out_bytes + in_bytes)

    def _add(self, name: str, shapes: str, flops: float, nbytes: float):
        k = counting.scale()
        flops, nbytes = flops * k, nbytes * k
        self.flops += flops
        self.hbm_bytes += nbytes
        rec = self.by_op.setdefault((name, shapes), [0, 0.0, 0.0])
        rec[0] += k
        rec[1] += flops
        rec[2] += nbytes

    # -- what the dispatcher sees -----------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if counting.in_kernel_call() or func.is_view \
                or func in _NO_TRAFFIC or func.namespace != "aten":
            return out
        packet = func.overloadpacket
        flops = 0.0
        if packet in self._registry:
            flops = float(self._registry[packet](*args, **kwargs,
                                                 out_val=out))
        if func in _GATHERS:
            nbytes = 2 * _tensor_bytes(out)
        elif func in _UPDATES:
            nbytes = 2 * _tensor_bytes(args[_UPDATES[func]])
        else:
            nbytes = _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        shapes = ",".join(str(tuple(t.shape)) for t in tree_flatten(
            args)[0] if isinstance(t, torch.Tensor))[:80]
        self._add(str(packet), shapes, flops, nbytes)
        return out

    def __enter__(self):
        self._ctx = counting.counting(self)
        self._ctx.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ctx.__exit__(*exc)

    def summary(self) -> dict:
        coll = dict(self.collective_bytes)
        coll["total"] = sum(coll.values())
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": coll, "kernels": dict(self.kernels)}


def count(fn, *args, **kwargs) -> Tuple[Any, Counter]:
    """``fn(*args, **kwargs)`` under a fresh `Counter`: (its result, the
    counter)."""
    counter = Counter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


# ---------------------------------------------------------------------------
# One rank of a cell, on meta tensors
# ---------------------------------------------------------------------------

def meta_inputs(plan) -> Tuple[tuple, dict]:
    """The arguments of one rank's step of ``plan`` (a `launch.steps`
    plan on an `AbstractMesh` or one device) as ``meta`` tensors: the
    compute model built and bound on ``meta``, the rank's parameter (and
    moment) blocks, its rows of the batch (int32 token ids, as the token
    pipeline's and the reference's), its cache blocks and a device
    position."""
    from repro_torch.launch.sharding import meta_model
    from repro_torch.launch.steps import batch_rows
    from repro_torch.models import init_caches
    from repro_torch.models.layers import dtype_of

    cfg, shape, mesh = plan.cfg, plan.shape, plan.mesh
    meta = dict(device="meta")
    B, T = shape.global_batch, shape.seq_len
    enc = (B, cfg.encoder_seq_len, cfg.d_model)
    enc_dtype = dtype_of(cfg.compute_dtype)
    model = meta_model(cfg)
    if plan.kind == "train":
        state = plan.init_state(model)
        batch = {"tokens": torch.empty((B, T), dtype=torch.int32, **meta)}
        batch["labels"] = torch.empty_like(batch["tokens"])
        if cfg.encoder_layers:
            batch["enc_emb"] = torch.empty(enc, dtype=enc_dtype, **meta)
        if mesh is not None:
            batch = batch_rows(batch, mesh)
        return (state, batch), {}
    params = plan.bind(model)
    if plan.kind == "prefill":
        args = [params, plan.rows(torch.empty((B, T), dtype=torch.int32,
                                              **meta))]
        if cfg.encoder_layers:
            args.append(plan.rows(torch.empty(enc, dtype=enc_dtype, **meta)))
        return tuple(args), {}
    caches = plan.cache_blocks(init_caches(cfg, B, T, device="meta"))
    tokens = plan.rows(torch.empty((B, 1), dtype=torch.int32, **meta))
    pos = torch.empty((), dtype=torch.int32, **meta)
    kwargs = {}
    if cfg.encoder_layers:
        kwargs["memory"] = plan.rows(torch.empty(enc, dtype=enc_dtype,
                                                 **meta))
    return (params, caches, tokens, pos), kwargs


def count_cell(plan) -> Tuple[dict, Counter]:
    """The count of one rank's step of ``plan`` on ``meta`` tensors
    (`meta_inputs`): (`Counter.summary`, the counter)."""
    args, kwargs = meta_inputs(plan)
    _, counter = count(plan.step_fn, *args, **kwargs)
    return counter.summary(), counter
