"""Named-axis meshes of ``torch.distributed`` ranks and the reference's
``lax`` collectives over them: the layer that the cross-device scans
(`repro_torch.core`) and mixers (`repro_torch.models`) build on.

In the JAX package a mesh is one process with named axes, and
``shard_map`` binds an ``axis_name`` inside a traced function. Here a
mesh is a set of SPMD ranks of ``torch.distributed``: each rank holds its
shard and runs the local function directly. A rank's place on the mesh is
its coordinates in the row-major layout of the mesh's shape; along each
axis the ranks that differ only in that coordinate form one process group
(a "line"), so ``mesh.shape["model"]`` reads as in JAX and a collective
over "model" runs on the rank's line. "Inside ``shard_map``" becomes
"inside ``with mesh:`` on a rank of that mesh". Building meshes and
starting ranks is `repro_torch.launch.mesh`'s.

The collectives (`axis_index`, `axis_size`, `ppermute`, `psum`, `pmean`,
`pmax`, `all_gather`, `psum_scatter`, `all_to_all`) take the reference's
arguments and read the ambient mesh; an axis name with no mesh around it,
or one the mesh does not have, raises ``NameError`` as JAX's unbound axis
does. ``x`` may be a tensor or a tuple / NamedTuple of tensors (one
exchange carries every leaf). `axis_size` is a Python int from the mesh's
shape (``lax.psum(1, axis)`` is static too) and `axis_index` the rank's
coordinate, a Python int: code branches on it where JAX selects with
``jnp.where``, and every rank still takes part in every exchange.

Backends: NCCL where every rank has a card of its own; gloo on the CPU
and where ranks share a card (NCCL refuses two ranks of one communicator
on one device). gloo moves host memory, so a collective on CUDA tensors
under gloo copies them to the host and back in `_host_staged`, the one
place that does, and adds the bytes to ``mesh.staged_bytes``: a transport
for bytes, never a CPU path for compute.

Under autograd (training), `ppermute`, `psum`, `pmean`, `all_gather`,
`psum_scatter` and `all_to_all` have backward passes, and `pvary` marks
a replicated value as one that each rank uses in its own way. The
convention is JAX's for typed shard_map: a value replicated over an axis
carries the whole cotangent on every rank of it. So the transpose of
`psum` is the identity, `all_gather` keeps the rank's own block of the
cotangent, `psum_scatter` all_gathers it, `all_to_all` and `ppermute`
run backwards, and `pvary` (identity forward) sums the ranks' cotangents
with `psum`. Every rank then seeds the same loss, a parameter used in the
same way on every rank of an axis gets the same gradient there, and one
that a rank uses on its own slice (a router on the rank's tokens) goes
through `pvary`. Gradients of data-parallel replicas still need their sum
over the batch axes: that is the train step's, as JAX leaves it to GSPMD.
The mesh is kept with each operation, so a backward pass (or a block's
recomputation in it) that runs on autograd's own thread still reaches it.
Megatron's tensor-parallel regions are these collectives by their own
names: `copy_to_region` (`pvary`: identity forward, sum backward) and
`reduce_from_region` (`psum`: sum forward, identity backward), and for a
sequence-parallel residual stream `gather_sequence` (all_gather forward,
reduce-scatter backward) and `scatter_sequence` (`psum_scatter`).
`exchange_rows` moves a weight's rows, outside autograd, from the layout
it rests in over an axis to another (the SSM's ``in_proj`` under tensor
parallelism), point to point.

`PartitionSpec` (``P``) is a tensor's layout on a mesh: per dimension an
axis name, a tuple of names (split row-major over them) or None (whole).
`NamedSharding` pairs a mesh (a `Mesh`, or an `AbstractMesh` that has
only the axis sizes) with a spec: `NamedSharding.block` takes the rank's
block of a full tensor and `NamedSharding.gather` the full tensor from
every rank's block.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import counting

#: ``reduce_scatter_single`` is ``reduce_scatter_tensor``'s newer name.
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

#: The stack of ambient meshes (``with mesh:``), process-wide: autograd
#: runs a CUDA backward pass, and the recomputation of a checkpointed
#: block, on a thread of its own, which must see the mesh too.
_AMBIENT: List["Mesh"] = []


class Mesh:
    """A mesh of ``math.prod(shape)`` ranks with named axes.

    Built collectively: every rank of the default process group constructs
    it with the same arguments (each axis's process groups are created in
    the same order everywhere). Without an initialised process group only
    a one-rank mesh can be built, and every collective on it is the
    identity. ``shape`` is a dict ``{axis name: size}`` in axis order,
    ``coords`` the rank's coordinate on each axis, ``staged_bytes`` the
    bytes its collectives copied through the host (`_host_staged`)."""

    #: A mesh of ranks (`AbstractMesh`: of axis sizes alone).
    abstract = False

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                             f"{tuple(axis_names)} do not match")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        ready = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if ready else 1
        if world != self.size:
            raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                             f"{self.size} ranks; the process group has "
                             f"{world}")
        self.rank = dist.get_rank() if ready else 0
        self.backend = dist.get_backend() if ready else None
        self.coords: Dict[str, int] = {}
        rest = self.rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {n: self.coords[n] for n in self.axis_names}
        self.staged_bytes = 0
        self._lines: Dict[str, List[int]] = {}
        self._groups: Dict[str, Any] = {}
        for name in self.axis_names:
            for line in self._all_lines(name):
                # new_group is collective over the whole default group:
                # every rank creates every line, in the same order.
                group = (dist.new_group(line)
                         if ready and self.shape[name] > 1 else None)
                if self.rank in line:
                    self._lines[name], self._groups[name] = line, group

    def _all_lines(self, name: str) -> List[List[int]]:
        axis = self.axis_names.index(name)
        strides = [math.prod(list(self.shape.values())[i + 1:])
                   for i in range(len(self.axis_names))]
        lines = []
        for r in range(self.size):
            if (r // strides[axis]) % self.shape[name] == 0:
                lines.append([r + j * strides[axis]
                              for j in range(self.shape[name])])
        return lines

    def line(self, name: str) -> List[int]:
        """Global ranks along axis ``name`` through this rank, by
        coordinate (a process group's rank order: ascending)."""
        return self._lines[name]

    def group(self, name: str):
        return self._groups[name]

    def __enter__(self) -> "Mesh":
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"backend {self.backend})")


def active_mesh() -> Optional[Mesh]:
    """The ambient mesh (``with mesh:``), or None."""
    return _AMBIENT[-1] if _AMBIENT else None


# ---------------------------------------------------------------------------
# Collectives over the ambient mesh
# ---------------------------------------------------------------------------

def _bound(axis_name: str) -> Mesh:
    mesh = active_mesh()
    if mesh is None or axis_name not in mesh.shape:
        where = ("no mesh is active" if mesh is None
                 else f"the mesh has axes {mesh.axis_names}")
        raise NameError(f"unbound axis name: {axis_name!r} ({where}; call "
                        "inside `with mesh:` on a rank of a mesh that has "
                        "the axis)")
    return mesh


def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_size(axis_name) -> int:
    """Ranks along ``axis_name`` (a name or a tuple of names)."""
    return math.prod(_bound(a).shape[a] for a in _axes(axis_name))


def axis_index(axis_name: str) -> int:
    """This rank's coordinate along ``axis_name``."""
    return _bound(axis_name).coords[axis_name]


def _leaves(x) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _rebuild(x, leaves: List[torch.Tensor]):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*leaves)
    if isinstance(x, (tuple, list)):
        return type(x)(leaves)
    return leaves[0]


def _host_staged(mesh: Mesh, tensors: Sequence[torch.Tensor]):
    """The tensors a collective hands to the backend, and a function that
    takes the backend's results back to the inputs' device. Under gloo a
    CUDA tensor is copied to the host (its bytes added to
    ``mesh.staged_bytes``) and its result copied back; anything else goes
    as it is."""
    staged = mesh.backend == "gloo" and any(t.is_cuda for t in tensors)
    if not staged:
        return [t.contiguous() for t in tensors], lambda t, like: t
    mesh.staged_bytes += sum(t.numel() * t.element_size() for t in tensors)

    def back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        mesh.staged_bytes += t.numel() * t.element_size()
        return t.to(like.device)

    return [t.detach().cpu().contiguous() for t in tensors], back


def _ppermute(mesh: Mesh, leaves: List[torch.Tensor], axis_name: str,
              perm: Sequence[tuple]) -> List[torch.Tensor]:
    me = mesh.coords[axis_name]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if src == [me] or (not src and not dst):
        return [t.clone() if src else torch.zeros_like(t) for t in leaves]
    counting.collective("collective-permute", leaves, leaves)
    if mesh.abstract:
        return [t.clone() if src else torch.zeros_like(t) for t in leaves]
    line = mesh.line(axis_name)
    sent, back = _host_staged(mesh, leaves)
    recv = [torch.empty_like(t) for t in sent]
    ops = []
    if dst and dst[0] != me:
        ops += [dist.P2POp(dist.isend, t, line[dst[0]]) for t in sent]
    if src and src[0] != me:
        ops += [dist.P2POp(dist.irecv, t, line[src[0]]) for t in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return ([back(t, like) for t, like in zip(recv, leaves)] if src
            else [torch.zeros_like(t) for t in leaves])


def _all_reduce(mesh: Mesh, leaves: List[torch.Tensor], axes: tuple,
                op) -> List[torch.Tensor]:
    # The reduction runs in place on copies: the inputs stay as they are.
    out = [t.detach().clone() for t in leaves]
    for name in axes:
        if mesh.shape[name] == 1:
            continue
        counting.collective("all-reduce", out, out)
        if mesh.abstract:
            continue
        sent, back = _host_staged(mesh, out)
        for t in sent:
            dist.all_reduce(t, op=op, group=mesh.group(name))
        out = [back(t, like) for t, like in zip(sent, out)]
    return out


def _all_gather_leaf(mesh: Mesh, name: str, t: torch.Tensor
                     ) -> List[torch.Tensor]:
    D = mesh.shape[name]
    if D == 1:
        return [t]
    counting.collective("all-gather", [t] * D, [t])
    if mesh.abstract:
        return [t] * D
    (sent,), back = _host_staged(mesh, [t])
    parts = [torch.empty_like(sent) for _ in range(mesh.shape[name])]
    dist.all_gather(parts, sent, group=mesh.group(name))
    return [back(p, t) for p in parts]


def _all_gather(mesh: Mesh, leaves: List[torch.Tensor], axis_name: str,
                axis: int, tiled: bool) -> List[torch.Tensor]:
    out = []
    for t in leaves:
        parts = _all_gather_leaf(mesh, axis_name, t.detach())
        out.append(torch.cat(parts, dim=axis) if tiled
                   else torch.stack(parts, dim=axis))
    return out


def _own_block(mesh: Mesh, leaves: List[torch.Tensor], axis_name: str,
               axis: int, tiled: bool) -> List[torch.Tensor]:
    """The rank's block of each of ``leaves`` along ``axis``, as
    `all_gather` lays the blocks out: the transpose of an all_gather to a
    replicated value."""
    me, D = mesh.coords[axis_name], mesh.shape[axis_name]
    if not tiled:
        return [t.select(axis, me) for t in leaves]
    return [t.narrow(axis, me * (t.shape[axis] // D), t.shape[axis] // D)
            for t in leaves]


def _psum_scatter(mesh: Mesh, leaves: List[torch.Tensor], axis_name: str,
                  sd: int, tiled: bool) -> List[torch.Tensor]:
    D = mesh.shape[axis_name]
    out = []
    for t in leaves:
        if t.shape[sd] % D if tiled else t.shape[sd] != D:
            raise ValueError(f"psum_scatter: dimension {sd} of "
                             f"{tuple(t.shape)} does not split over {D} "
                             "ranks")
        if D == 1:
            part = t.detach().clone()
        elif mesh.abstract:
            part = t.detach().narrow(sd, 0, t.shape[sd] // D).clone()
            counting.collective("reduce-scatter", [part], [t])
        else:
            counting.collective("reduce-scatter", [t.narrow(
                sd, 0, t.shape[sd] // D)], [t])
            (sent,), back = _host_staged(mesh, [t.detach().movedim(sd, 0)])
            recv = sent.new_empty((sent.shape[0] // D,) + sent.shape[1:])
            _reduce_scatter(recv, sent, group=mesh.group(axis_name))
            part = back(recv, t).movedim(0, sd)
        out.append(part if tiled else part.squeeze(sd))
    return out


def _all_to_all(mesh: Mesh, leaves: List[torch.Tensor], axis_name: str,
                split_axis: int, concat_axis: int, tiled: bool
                ) -> List[torch.Tensor]:
    D = mesh.shape[axis_name]
    out = []
    for t in leaves:
        if t.shape[split_axis] % D:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(t.shape)} does not split over {D} "
                             "ranks")
        blocks = list(t.detach().chunk(D, dim=split_axis))
        if D > 1:
            counting.collective("all-to-all", [t], [t])
        if D > 1 and not mesh.abstract:
            # Point to point (gloo has no all-to-all in every version):
            # block j to axis index j, one block from every other.
            me, line = mesh.coords[axis_name], mesh.line(axis_name)
            others = [j for j in range(D) if j != me]
            sent, back = _host_staged(mesh, [blocks[j] for j in others])
            recv = [torch.empty_like(b) for b in sent]
            ops = [dist.P2POp(dist.isend, b, line[j])
                   for b, j in zip(sent, others)]
            ops += [dist.P2POp(dist.irecv, b, line[j])
                    for b, j in zip(recv, others)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for b, j in zip(recv, others):
                blocks[j] = back(b, t)
        if tiled:
            out.append(torch.cat(blocks, dim=concat_axis))
        else:
            blocks = [b.squeeze(split_axis) for b in blocks]
            out.append(torch.stack(blocks, dim=concat_axis))
    return out


def exchange_rows(t: torch.Tensor, mesh, axis_name: str,
                  held: Callable[[int], Sequence[int]],
                  wanted: Callable[[int], Sequence[int]]) -> torch.Tensor:
    """Rows of a tensor split over the ranks of ``axis_name`` moved from
    one layout into another: ``held(i)`` and ``wanted(i)`` are the global
    row indices axis index ``i`` holds before and after, each row held by
    one rank of the axis in each layout. ``t`` holds this rank's rows in
    ``held`` order; the result its rows in ``wanted`` order. Each rank
    keeps what it holds and wants, and sends each peer, point to point,
    the rows it holds that the peer wants (an all-to-all of uneven
    parts). No gradient: the layouts of a weight at rest and in use."""
    me, D = mesh.coords[axis_name], mesh.shape[axis_name]
    want = list(wanted(me))
    at = {g: i for i, g in enumerate(held(me))}
    out = t.new_empty((len(want),) + tuple(t.shape[1:]))
    dev = t.device

    def rows(idx):
        return torch.tensor(idx, dtype=torch.long, device=dev)

    mine = [(k, at[g]) for k, g in enumerate(want) if g in at]
    if mine:
        dst, src = zip(*mine)
        out.index_copy_(0, rows(dst), t.detach().index_select(0, rows(src)))
    sends, recvs = [], []
    for j in range(D):
        if j == me:
            continue
        to_j = [at[g] for g in wanted(j) if g in at]
        theirs = set(held(j))
        from_j = [k for k, g in enumerate(want) if g in theirs]
        if to_j:
            sends.append((j, t.detach().index_select(0, rows(to_j))))
        if from_j:
            recvs.append((j, from_j))
    if D > 1:
        counting.collective("all-to-all", [out], [t])
    if mesh.abstract or not (sends or recvs):
        return out
    line = mesh.line(axis_name)
    sent, _ = _host_staged(mesh, [s for _, s in sends])
    staged = mesh.backend == "gloo" and t.is_cuda
    got = [torch.empty((len(idx),) + tuple(t.shape[1:]), dtype=t.dtype,
                       device="cpu" if staged else dev) for _, idx in recvs]
    ops = [dist.P2POp(dist.isend, s, line[j])
           for (j, _), s in zip(sends, sent)]
    ops += [dist.P2POp(dist.irecv, g, line[j])
            for (j, _), g in zip(recvs, got)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for (_, idx), g in zip(recvs, got):
        if staged:
            mesh.staged_bytes += g.numel() * g.element_size()
        out.index_copy_(0, rows(idx), g.to(dev))
    return out


class _Collective(torch.autograd.Function):
    """A collective with its transpose (module docstring): ``forward``
    and ``backward`` are ``(mesh, leaves) -> leaves`` functions, the
    mesh kept from the forward call."""

    @staticmethod
    def forward(ctx, fwd, bwd, mesh, *leaves):
        ctx.bwd, ctx.mesh = bwd, mesh
        return tuple(fwd(mesh, list(leaves)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(ctx.bwd(ctx.mesh, list(grads)))


def _run(x, mesh: Mesh, fwd: Callable, bwd: Optional[Callable]):
    """``fwd`` on the leaves of ``x``; under autograd, with ``bwd`` as
    its backward (None: no gradient flows back)."""
    leaves = _leaves(x)
    if bwd is None or not (torch.is_grad_enabled()
                           and any(t.requires_grad for t in leaves)):
        return _rebuild(x, fwd(mesh, leaves))
    return _rebuild(x, list(_Collective.apply(fwd, bwd, mesh, *leaves)))


def ppermute(x, axis_name: str, perm: Sequence[tuple]):
    """``lax.ppermute``: send this rank's ``x`` to axis index ``dst`` for
    each ``(src, dst)`` in ``perm`` with ``src`` this rank's index;
    receive from the ``src`` that names this rank as its ``dst``, or zeros
    where none does. Every leaf goes in one ``batch_isend_irecv``. The
    backward pass sends the cotangents by the inverse permutation."""
    mesh = _bound(axis_name)
    perm = [tuple(p) for p in perm]
    inverse = [(d, s) for s, d in perm]
    return _run(x, mesh,
                lambda m, ls: _ppermute(m, ls, axis_name, perm),
                lambda m, gs: _ppermute(m, gs, axis_name, inverse))


def _identity(mesh, grads):
    return grads


def psum(x, axis_name):
    """Sum over the ranks of ``axis_name`` (a name or a tuple of names).
    The result is replicated over them, so its backward pass is the
    identity (module docstring)."""
    axes = _axes(axis_name)
    mesh = _bound(axes[0]) if axes else active_mesh()
    for a in axes:
        _bound(a)
    return _run(x, mesh,
                lambda m, ls: _all_reduce(m, ls, axes, dist.ReduceOp.SUM),
                _identity)


def pmax(x, axis_name):
    """The largest value over the ranks of ``axis_name``; no gradient."""
    axes = _axes(axis_name)
    for a in axes:
        _bound(a)
    return _rebuild(x, _all_reduce(active_mesh(), _leaves(x), axes,
                                   dist.ReduceOp.MAX))


def pmean(x, axis_name):
    n = axis_size(axis_name)
    total = psum(x, axis_name)
    return _rebuild(total, [t / n for t in _leaves(total)])


def pvary(x, axis_name: str):
    """``x``, replicated over ``axis_name``, as a value each rank goes on
    to use in its own way (its slice, its shard of a weight): the
    identity, whose backward pass sums the ranks' cotangents over the
    axis (`psum`), as the transpose of JAX's ``pvary`` does."""
    mesh = _bound(axis_name)
    return _run(x, mesh, lambda m, ls: [t.view_as(t) for t in ls],
                lambda m, gs: _all_reduce(m, gs, (axis_name,),
                                          dist.ReduceOp.SUM))


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = False):
    """``lax.all_gather``: every rank's ``x`` by axis index, stacked on a
    new dimension ``axis`` or, ``tiled``, concatenated along ``axis``. The
    result is replicated over the axis: the backward pass keeps the
    rank's own block of the cotangent."""
    mesh = _bound(axis_name)
    return _run(x, mesh,
                lambda m, ls: _all_gather(m, ls, axis_name, axis, tiled),
                lambda m, gs: _own_block(m, gs, axis_name, axis, tiled))


def psum_scatter(x, axis_name: str, *, scatter_dimension: int = 0,
                 tiled: bool = False):
    """``lax.psum_scatter``: the sum over the axis, of which this rank
    keeps block ``axis_index`` along ``scatter_dimension`` (``tiled``; else
    that dimension has the axis's size and is dropped). One
    reduce-scatter per leaf; the backward pass all_gathers the
    cotangents."""
    mesh = _bound(axis_name)
    sd = scatter_dimension
    return _run(x, mesh,
                lambda m, ls: _psum_scatter(m, ls, axis_name, sd, tiled),
                lambda m, gs: _all_gather(m, gs, axis_name, sd, tiled))


def copy_to_region(x, axis_name: str):
    """Megatron's entry to a tensor-parallel region: the identity, whose
    backward pass sums the ranks' partial cotangents over ``axis_name``
    (`pvary`). Each rank of the axis goes on to multiply ``x`` by its own
    block of a column-parallel weight."""
    return pvary(x, axis_name)


def reduce_from_region(x, axis_name: str):
    """Megatron's exit from a tensor-parallel region: the sum of the
    ranks' partial products of a row-parallel weight over ``axis_name``
    (`psum`); the result is replicated, so its backward pass is the
    identity."""
    return psum(x, axis_name)


def gather_sequence(x, axis_name: str, dim: int = 1):
    """The entry to a tensor-parallel region from a sequence-parallel
    residual stream: the ranks' blocks of ``x`` along ``dim`` concatenated
    (an all_gather), whose backward pass sums the ranks' partial
    cotangents and keeps the rank's block (a reduce-scatter): `all_gather`
    and `pvary` in one exchange each way."""
    mesh = _bound(axis_name)
    return _run(x, mesh,
                lambda m, ls: _all_gather(m, ls, axis_name, dim, True),
                lambda m, gs: _psum_scatter(m, gs, axis_name, dim, True))


def scatter_sequence(x, axis_name: str, dim: int = 1):
    """The exit from a tensor-parallel region into a sequence-parallel
    residual stream: the ranks' partial sums of ``x`` summed, of which the
    rank keeps its block along ``dim`` (`psum_scatter`, tiled; its
    backward pass all_gathers the cotangent)."""
    return psum_scatter(x, axis_name, scatter_dimension=dim, tiled=True)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = False):
    """``lax.all_to_all``: split ``x`` along ``split_axis`` into one block
    per rank of the axis, send block ``j`` to axis index ``j``, and join
    the blocks received, by source index, along ``concat_axis``
    (concatenated when ``tiled``, else stacked with the split axis
    dropped). The backward pass is the all_to_all with the two axes
    swapped."""
    mesh = _bound(axis_name)
    return _run(x, mesh,
                lambda m, ls: _all_to_all(m, ls, axis_name, split_axis,
                                          concat_axis, tiled),
                lambda m, gs: _all_to_all(m, gs, axis_name, concat_axis,
                                          split_axis, tiled))


# ---------------------------------------------------------------------------
# Partition specs and shardings
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """``P(*entries)``: per dimension of a tensor an axis name, a tuple of
    axis names or None; dimensions past the entries are whole. A tuple,
    so it compares equal to JAX's ``PartitionSpec`` with the same
    entries (a tuple of one name is that name, as in JAX)."""

    def __new__(cls, *entries):
        # A one-name tuple is that name, as JAX normalises it.
        entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                        else e for e in entries)
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


def entry_axes(entry) -> tuple:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec) -> tuple:
    """Every axis name a spec uses, in order."""
    return tuple(a for e in spec for a in entry_axes(e))


def tree_map(fn: Callable, tree, *others, is_leaf: Callable):
    """``fn(leaf, *matching)`` for every leaf (``is_leaf(x)``) of ``tree``,
    a nesting of dicts, lists and tuples (NamedTuples too), and the
    matching leaves of ``others`` (nested alike), in the same nesting."""
    if is_leaf(tree):
        return fn(tree, *others)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(o[i] for o in others), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    raise TypeError(f"not a leaf or a container: {tree!r}")


def map_specs(fn: Callable, specs, *others):
    """`tree_map` over the `PartitionSpec` leaves of ``specs``."""
    return tree_map(fn, specs, *others,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def shape_of(like) -> tuple:
    """A shape, from a shape or from anything with a ``.shape``."""
    return tuple(like.shape) if hasattr(like, "shape") else tuple(like)


def widen_spec(spec, shape, size: int, *, least: int = 0):
    """``spec`` with "data" on the largest unsharded dimension of
    ``shape`` that ``size`` divides and that is longer than ``least``
    (the first of equal ones), unless it uses "data" already: the rule of
    the reference's ``fsdp_widen`` (``least`` 0) and ``zero_specs``
    (``least`` -1)."""
    if "data" in spec_axes(spec):
        return spec
    shape = shape_of(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = least, -1
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % size == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0:
        entries[best_dim] = "data"
    return P(*entries)


class AbstractMesh:
    """The axis sizes of a mesh without its ranks: what a spec's block
    shapes need (`NamedSharding.shard_shape`), e.g. the 16 x 16
    production mesh on a machine with one process.

    It also stands in for the mesh's first rank, so that a step can be
    traced for one rank on ``meta`` tensors (`launch.cost`): under
    ``with mesh:`` every collective returns a result of the right shape
    (its own input where data would come from other ranks, zeros where
    `ppermute` sends none) and reports its bytes
    (`repro_torch.counting`), with no process group."""

    abstract = True

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.coords = {a: 0 for a in self.axis_names}
        self.rank = 0
        self.backend = None
        self.staged_bytes = 0

    def __enter__(self) -> "AbstractMesh":
        _AMBIENT.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.pop()

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


class NamedSharding:
    """A spec on a mesh (a `Mesh`, or an `AbstractMesh` for shapes only).
    A dimension whose entry names axes ``(a1, ..., ak)`` is cut into
    ``prod(sizes)`` equal blocks, and the rank holds block ``c1 * s2 ...
    sk + ... + ck`` of its coordinates (row-major, as JAX lays them out).
    """

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        missing = [a for a in spec_axes(self.spec)
                   if a not in mesh.shape]
        if missing:
            raise ValueError(f"spec {self.spec} names axes {missing} that "
                             f"the mesh {dict(mesh.shape)} lacks")

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"

    def _entries(self, ndim: int) -> list:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"{ndim} dimensions of its tensor")
        return list(self.spec) + [None] * (ndim - len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The shape of one rank's block of a ``shape`` tensor (a
        dimension that does not divide is rounded up, as GSPMD pads)."""
        out = []
        for e, dim in zip(self._entries(len(shape)), shape):
            n = math.prod(self.mesh.shape[a] for a in entry_axes(e))
            out.append(-(-int(dim) // n))
        return tuple(out)

    def _index(self, axes: tuple) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
        return idx

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        t = full
        for dim, e in enumerate(self._entries(full.dim())):
            axes = entry_axes(e)
            n = math.prod(self.mesh.shape[a] for a in axes)
            if n == 1:
                continue
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(full.shape)} "
                                 f"does not split over {n} ranks "
                                 f"({self.spec})")
            size = t.shape[dim] // n
            t = t.narrow(dim, self._index(axes) * size, size)
        return t

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's ``block`` (collective over
        the spec's axes; no gradient)."""
        return coarsen_block(block.detach(), self,
                             NamedSharding(self.mesh, P()))


def _extra_axes(outer, inner) -> tuple:
    """The axes of spec entry ``inner`` past those of ``outer``, which
    must be a prefix of them."""
    o, i = entry_axes(outer), entry_axes(inner)
    if i[:len(o)] != o:
        raise ValueError(f"spec entry {inner!r} does not refine {outer!r}")
    return i[len(o):]


def _entry_pairs(outer: NamedSharding, inner: NamedSharding, ndim: int):
    return enumerate(zip(outer._entries(ndim), inner._entries(ndim)))


def refine_block(t: torch.Tensor, outer: NamedSharding,
                 inner: NamedSharding) -> torch.Tensor:
    """A block under ``outer`` cut to this rank's block under ``inner``,
    whose entries extend ``outer``'s by more axes (a view)."""
    mesh = inner.mesh
    for dim, (oe, ie) in _entry_pairs(outer, inner, t.dim()):
        for a in _extra_axes(oe, ie):
            size = t.shape[dim] // mesh.shape[a]
            t = t.narrow(dim, mesh.coords[a] * size, size)
    return t


def coarsen_block(t: torch.Tensor, inner: NamedSharding,
                  outer: NamedSharding) -> torch.Tensor:
    """The inverse of `refine_block`: the block under ``outer`` from the
    ranks' blocks under ``inner`` (all_gathers over the extra axes; no
    gradient). ``t`` itself where there are none."""
    mesh = inner.mesh
    for dim, (oe, ie) in _entry_pairs(outer, inner, t.dim()):
        for a in reversed(_extra_axes(oe, ie)):
            if mesh.shape[a] > 1:
                t = _all_gather(mesh, [t], a, dim, True)[0]
    return t
