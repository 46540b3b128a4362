"""Associative scan with combine-impl dispatch.

torch has no ``lax.associative_scan``, so :func:`associative_scan` runs
the same odd/even recursion (``jax/_src/lax/control_flow/loops.py``):
combine adjacent pairs ``x[0:-1:2]`` with ``x[1::2]``, scan the half-size
result recursively (the odd outputs), combine those with ``x[2::2]`` (the
even outputs), prepend ``x[0]`` and interleave. Every level therefore
combines exactly the pairs the JAX scan combines, in the same order: two
combine calls per level, the second of the n=2 level with zero pairs.

A *combine* takes ``(earlier, later)`` elements (time order). A reverse
(suffix) scan flips the time axis, scans with the argument-swapped
operator, and flips back — the JAX package's convention, so callers
always write the combine in ``(earlier, later)`` form.

Batching contract: element tuples may carry ``batch_dims`` leading batch
axes before the time axis (``[B..., T, ...]``). A combine that takes a
grid of pairs (the CUDA kernels) gets every level's ``[B..., P]`` pairs
as views of ``[L, P]`` pairs, ``L = prod(B...)``: the strided level slices
themselves, with no packing copy — one launch per level for the whole
fleet. Merging the batch axes into ``L`` is a view wherever their strides
allow (every call of the smoother's scans); where they do not, the level
is copied and the copy counted in `PACK_COPIES`. Combines that broadcast
over leading axes (the plain versions) get the slices as they are.

`linear_recurrence_scan` is the diagonal special case used by SSM layers;
its "pallas" path runs the ssm_scan kernel instead of the recursion.

Cross-device scans (``axis_name``; `sharded_associative_scan`,
`device_exclusive_scan`): the time axis is sharded over a mesh axis of
ranks (`repro_torch.distributed`); each rank scans its shard, the ranks
exchange their shards' aggregates by a Hillis-Steele exclusive scan of
``ceil(log2 D)`` `ppermute` rounds and one shift, and each rank combines
what comes before it into its shard. That is the cluster-level form of
the paper's method: span O(log n_local + log D). The batch axes are never
sharded.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import axis_index, axis_size, ppermute


#: Copies `_pair_grid_op` made because a level's leading batch axes did
#: not merge into one view (none on the smoother's path).
PACK_COPIES = 0


def _batched_combine(combine: Callable, combine_impl: str
                     ) -> Tuple[Callable, bool]:
    """Return ``(op, on_pair_grid)``: the operator for ``combine`` under
    ``combine_impl``, and whether it takes an ``[L, P]`` grid of pairs (so
    the scan must merge each level's leading batch axes into ``L``)."""
    # Late import: the kernels' oracles depend on core.
    from repro_torch.kernels.kalman_combine import ops as kc_ops

    if combine_impl == "jnp":
        return combine, False
    if combine_impl == "fused":
        return kc_ops.plain_batched_combine_for(combine), False
    if combine_impl == "pallas" or combine_impl.startswith("pallas:"):
        kc_ops.resolve_backend(combine_impl.partition(":")[2] or None)
        return kc_ops.batched_combine_for(combine)
    raise ValueError(f"unknown combine_impl {combine_impl!r}")


def _as_pair_grid(x: torch.Tensor, nlead: int) -> torch.Tensor:
    """``x [B..., P, ...]`` (``nlead`` leading axes, the last one the
    pairs) as ``[L, P, ...]``: a view when the batch axes merge, else a
    copy counted in `PACK_COPIES`."""
    global PACK_COPIES
    shape = ((math.prod(x.shape[:nlead - 1]), x.shape[nlead - 1])
             + tuple(x.shape[nlead:]))
    try:
        return x.view(shape)
    except RuntimeError:  # the batch axes' strides do not merge
        PACK_COPIES += 1
        return x.reshape(shape)


def _pair_grid_op(batched: Callable, nlead: int) -> Callable:
    """Wrap an operator on ``[L, P]`` pair grids so it accepts ``nlead``
    leading axes: each level's ``[B..., P, ...]`` slices are handed over
    as ``[L, P, ...]`` views (no packing) and the results restored."""

    def op(a, b):
        lead = a[0].shape[:nlead]
        out = batched(type(a)(*(_as_pair_grid(x, nlead) for x in a)),
                      type(b)(*(_as_pair_grid(x, nlead) for x in b)))
        return type(out)(*(x.reshape(lead + x.shape[2:]) for x in out))

    return op


def _slice(x: torch.Tensor, axis: int, start, stop, step=None) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """``out[0::2] = even``, ``out[1::2] = odd`` along ``axis``."""
    shape = list(even.shape)
    shape[axis] = even.shape[axis] + odd.shape[axis]
    out = even.new_empty(shape)
    out[(slice(None),) * axis + (slice(0, None, 2),)] = even
    out[(slice(None),) * axis + (slice(1, None, 2),)] = odd
    return out


def _scan(op: Callable, elems, axis: int):
    num = elems[0].shape[axis]
    if num < 2:
        return elems
    cls = type(elems)
    sl = lambda start, stop, step=None: cls(*(  # noqa: E731
        _slice(x, axis, start, stop, step) for x in elems))
    reduced = op(sl(0, -1, 2), sl(1, None, 2))
    odd = _scan(op, reduced, axis)
    if num % 2 == 0:
        even = op(cls(*(_slice(x, axis, 0, -1) for x in odd)),
                  sl(2, None, 2))
    else:
        even = op(odd, sl(2, None, 2))
    even = cls(*(torch.cat([_slice(x, axis, 0, 1), e], dim=axis)
                 for x, e in zip(elems, even)))
    return cls(*(_interleave(e, o, axis) for e, o in zip(even, odd)))


def associative_scan(combine: Callable, elems, *, reverse: bool = False,
                     combine_impl: str = "jnp",
                     axis_name: Optional[str] = None,
                     identity: Optional[Callable] = None,
                     batch_dims: int = 0):
    """Inclusive associative scan over the time axis of ``elems``.

    Args:
      combine: pair combine in ``(earlier, later)`` order, broadcasting
        over leading axes (`repro_torch.core.parallel`'s combines, or any
        user operator written that way).
      elems: a NamedTuple of tensors ``[B..., T, ...]``.
      reverse: suffix scan (e.g. smoothing) instead of prefix scan.
      combine_impl: "jnp" (``combine`` as given — the textbook combines),
        "fused" (the plain versions of the kernel math), or "pallas" /
        "pallas:gpu" (the CUDA kernels on CUDA tensors, their plain
        versions on CPU tensors).
      axis_name: if set, the cross-device scan along this axis of the
        ambient mesh (`sharded_associative_scan`; call inside ``with
        mesh:`` on a rank): the time axis of ``elems`` is this rank's
        shard. Outside a mesh it raises ``NameError``.
      identity: zero-arg callable giving the combine's identity element
        (required by the cross-device scan).
      batch_dims: number of leading batch axes before the time axis.
    """
    if axis_name is not None:
        if identity is None:
            raise ValueError("sharded scan requires an identity element")
        return sharded_associative_scan(
            combine, elems, axis_name=axis_name, identity=identity(),
            reverse=reverse, combine_impl=combine_impl,
            batch_dims=batch_dims)
    batched, on_pair_grid = _batched_combine(combine, combine_impl)
    if on_pair_grid:
        batched = _pair_grid_op(batched, batch_dims + 1)
    axis = batch_dims
    if reverse:
        op = lambda later_agg, earlier: batched(earlier, later_agg)  # noqa: E731
        flipped = type(elems)(*(torch.flip(x, (axis,)) for x in elems))
        out = _scan(op, flipped, axis)
        return type(out)(*(torch.flip(x, (axis,)) for x in out))
    return _scan(batched, elems, axis)


# ---------------------------------------------------------------------------
# Cross-device scan (ranks of a mesh axis, `ppermute`)
# ---------------------------------------------------------------------------

def device_exclusive_scan(combine: Callable, agg, *, axis_name: str,
                          identity, reverse: bool = False):
    """Exclusive scan of one element per rank along ``axis_name``.

    Hillis-Steele over the mesh axis, as the reference's: ``ceil(log2
    D)`` `ppermute` rounds and one final shift, the same rounds and
    association, so the rounding agrees. ``agg`` is this rank's aggregate
    element (a NamedTuple or tuple of tensors, no time axis); ``identity``
    the combine's identity with the same shapes. A rank combines only
    where the reference's ``where`` keeps the combination; every rank
    takes part in every exchange.
    """
    D = axis_size(axis_name)
    idx = axis_index(axis_name)
    p = agg
    shift = 1
    while shift < D:
        if not reverse:
            # Bring the aggregate of the rank `shift` to the left.
            recv = ppermute(p, axis_name,
                            [(i, (i + shift) % D) for i in range(D)])
            p = combine(recv, p) if idx >= shift else _tie(p, recv)
        else:
            recv = ppermute(p, axis_name,
                            [(i, (i - shift) % D) for i in range(D)])
            p = combine(p, recv) if idx < D - shift else _tie(p, recv)
        shift *= 2
    if not reverse:
        excl = ppermute(p, axis_name, [(i, (i + 1) % D) for i in range(D)])
        first = idx == 0
    else:
        excl = ppermute(p, axis_name, [(i, (i - 1) % D) for i in range(D)])
        first = idx == D - 1
    return _tie(identity, excl) if first else excl


class _Tie(torch.autograd.Function):
    """``kept`` as it is, with a zero gradient for ``dropped``: keeps a
    received value that a rank does not combine in its autograd graph,
    so that the backward pass of the exchange that brought it runs on
    every rank (a collective's backward must run everywhere)."""

    @staticmethod
    def forward(ctx, n_kept, *tensors):
        ctx.n_kept = n_kept
        ctx.dropped = [(t.shape, t.dtype, t.device)
                       for t in tensors[n_kept:]]
        return tuple(t.view_as(t) for t in tensors[:n_kept])

    @staticmethod
    def backward(ctx, *grads):
        zeros = [torch.zeros(s, dtype=d, device=v)
                 for s, d, v in ctx.dropped]
        return (None,) + tuple(grads) + tuple(zeros)


def _tie(kept, dropped):
    """`_Tie` on tuples (NamedTuples) of tensors; ``kept`` itself when no
    gradient is recorded."""
    ks, ds = list(kept), list(dropped)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in ks + ds)):
        return kept
    out = _Tie.apply(len(ks), *ks, *ds)
    return (type(kept)(*out) if hasattr(kept, "_fields")
            else type(kept)(out))


def sharded_associative_scan(combine: Callable, elems, *, axis_name: str,
                             identity, reverse: bool = False,
                             combine_impl: str = "jnp",
                             batch_dims: int = 0):
    """Distributed inclusive scan: the local scan of this rank's shard,
    the cross-rank exclusive scan of the shards' aggregates, and the
    local fix-up.

    Call inside ``with mesh:`` with the time axis (axis ``batch_dims``)
    sharded along ``axis_name``; ``identity`` is the combine's identity
    element (unbatched). The local scan runs as `associative_scan` under
    ``combine_impl`` (on the card, "pallas" launches the combine kernels
    on the ``[L, P]`` grid of each level). The aggregate exchange carries
    every batch lane in one element per round and combines with the
    textbook ``combine``, as the reference's. The fix-up ``excl (x) loc``
    (``loc (x) excl`` reversed) is one more call of the local scan's
    operator on the whole shard, with ``excl`` read through a stride of 0
    along time: under "pallas" one more kernel launch over ``[B,
    n_local]`` pairs.
    """
    local = associative_scan(combine, elems, reverse=reverse,
                             combine_impl=combine_impl,
                             batch_dims=batch_dims)
    cls = type(local)
    agg = cls(*(x.select(batch_dims, 0 if reverse else -1) for x in local))
    lead = agg[0].shape[:batch_dims]
    ident = cls(*(i.to(a.device, a.dtype).expand(lead + i.shape)
                  for i, a in zip(identity, agg)))
    excl = device_exclusive_scan(combine, agg, axis_name=axis_name,
                                 identity=ident, reverse=reverse)
    return _fix_up(combine, excl, local, reverse=reverse,
                   combine_impl=combine_impl, batch_dims=batch_dims)


def _fix_up(combine: Callable, excl, local, *, reverse: bool,
            combine_impl: str, batch_dims: int):
    """``excl (x) loc`` at every step of the local scan ``local``
    (``loc (x) excl`` reversed): one call of the local scan's operator,
    ``excl`` (one element per batch lane) read through a stride of 0 along
    time."""
    excl = type(local)(*(e.unsqueeze(batch_dims).expand(x.shape)
                         for e, x in zip(excl, local)))
    batched, on_pair_grid = _batched_combine(combine, combine_impl)
    if on_pair_grid:
        batched = _pair_grid_op(batched, batch_dims + 1)
    return batched(local, excl) if reverse else batched(excl, local)


# ---------------------------------------------------------------------------
# Diagonal linear recurrences (the deterministic special case used by SSMs)
# ---------------------------------------------------------------------------

class LinearRecurrenceElement(NamedTuple):
    """Element of ``h_k = a_k * h_{k-1} + b_k`` (elementwise/diagonal)."""

    a: torch.Tensor
    b: torch.Tensor


def linear_recurrence_combine(ei: LinearRecurrenceElement,
                              ej: LinearRecurrenceElement
                              ) -> LinearRecurrenceElement:
    """Compose two diagonal affine maps, ``i`` earlier than ``j``.

    This is the paper's smoothing combine (Eq. 19) with diagonal ``E`` and
    the covariance dropped — the degenerate case powering SSM layers.
    """
    return LinearRecurrenceElement(a=ei.a * ej.a, b=ej.a * ei.b + ej.b)


def linear_recurrence_scan(a: torch.Tensor, b: torch.Tensor, *,
                           h0: Optional[torch.Tensor] = None,
                           axis_name: Optional[str] = None,
                           combine_impl: str = "jnp") -> torch.Tensor:
    """All states of ``h_k = a_k * h_{k-1} + b_k`` along the leading axis.

    ``a`` and ``b`` are ``[T, ...]``; optional initial state ``h0 [...]``
    is folded into the first element. Returns ``h [T, ...]``.

    ``combine_impl``: "jnp"/"fused" run `associative_scan` with
    `linear_recurrence_combine`; "pallas"/"pallas:gpu" flatten the trailing
    axes to ``[1, T, prod(...)]`` and run the ssm_scan kernel (its plain
    version on CPU tensors), for inputs of any rank.

    ``axis_name``: the time axis is this rank's shard along that axis of
    the ambient mesh, and ``h0`` is folded in only on the rank at axis
    index 0. Under "jnp"/"fused" it is `sharded_associative_scan`; under
    "pallas" the shard's own states ``h_loc`` and the running product
    ``A_loc`` of ``a`` (the recurrence with ``b = 0`` from ``h = 1``) are
    two ssm_scan launches, the ranks exchange their last ``(A_loc,
    h_loc)`` by `device_exclusive_scan`, and ``h = A_loc h_in + h_loc``.
    """
    if combine_impl not in ("jnp", "fused") and not (
            combine_impl == "pallas" or combine_impl.startswith("pallas:")):
        raise ValueError(f"unknown combine_impl {combine_impl!r}")
    first = axis_name is None or axis_index(axis_name) == 0
    if h0 is not None and a.shape[0] > 0 and first:
        b = torch.cat([(a[0] * h0 + b[0])[None], b[1:]])
    if combine_impl in ("jnp", "fused"):
        elems = LinearRecurrenceElement(a=a, b=b)
        if axis_name is None:
            return associative_scan(linear_recurrence_combine, elems).b
        ident = LinearRecurrenceElement(a=torch.ones_like(a[0]),
                                        b=torch.zeros_like(b[0]))
        return sharded_associative_scan(
            linear_recurrence_combine, elems, axis_name=axis_name,
            identity=ident, combine_impl=combine_impl).b

    from repro_torch.kernels.kalman_combine import ops as kc_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    kc_ops.resolve_backend(combine_impl.partition(":")[2] or None)
    flat = (1, a.shape[0], math.prod(a.shape[1:]))
    af = a.reshape(flat)
    h = ssm_ops.ssm_scan(af, b.reshape(flat)).reshape(a.shape)
    if axis_name is None:
        return h
    # A_loc: the product of a up to each step, h_0 = 1 folded into b[0].
    A = ssm_ops.ssm_scan(af, torch.zeros_like(af),
                         torch.ones_like(af[:, 0])).reshape(a.shape)
    ident = LinearRecurrenceElement(a=torch.ones_like(a[0]),
                                    b=torch.zeros_like(b[0]))
    h_in = device_exclusive_scan(
        linear_recurrence_combine,
        LinearRecurrenceElement(a=A[-1], b=h[-1]), axis_name=axis_name,
        identity=ident).b
    return A * h_in + h
