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
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

#: ``reduce_scatter_single`` is ``reduce_scatter_tensor``'s newer name.
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)

# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

_AMBIENT = threading.local()


class Mesh:
    """A mesh of ``math.prod(shape)`` ranks with named axes.

    Built collectively: every rank of the default process group constructs
    it with the same arguments (each axis's process groups are created in
    the same order everywhere). Without an initialised process group only
    a one-rank mesh can be built, and every collective on it is the
    identity. ``shape`` is a dict ``{axis name: size}`` in axis order,
    ``coords`` the rank's coordinate on each axis, ``staged_bytes`` the
    bytes its collectives copied through the host (`_host_staged`)."""

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
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"backend {self.backend})")


def active_mesh() -> Optional[Mesh]:
    """The ambient mesh (``with mesh:``), or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


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


def ppermute(x, axis_name: str, perm: Sequence[tuple]):
    """``lax.ppermute``: send this rank's ``x`` to axis index ``dst`` for
    each ``(src, dst)`` in ``perm`` with ``src`` this rank's index;
    receive from the ``src`` that names this rank as its ``dst``, or zeros
    where none does. Every leaf goes in one ``batch_isend_irecv``."""
    mesh = _bound(axis_name)
    me, line = mesh.coords[axis_name], mesh.line(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    leaves = _leaves(x)
    if src == [me] or (not src and not dst):
        out = [t.clone() if src else torch.zeros_like(t) for t in leaves]
        return _rebuild(x, out)
    sent, back = _host_staged(mesh, leaves)
    recv = [torch.empty_like(t) for t in sent]
    ops = []
    if dst and dst[0] != me:
        ops += [dist.P2POp(dist.isend, t, line[dst[0]]) for t in sent]
    if src and src[0] != me:
        ops += [dist.P2POp(dist.irecv, t, line[src[0]]) for t in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = ([back(t, like) for t, like in zip(recv, leaves)] if src
           else [torch.zeros_like(t) for t in leaves])
    return _rebuild(x, out)


def _all_reduce(x, axis_name, op):
    # The reduction runs in place on copies: the inputs stay as they are.
    out = [t.clone() for t in _leaves(x)]
    for name in _axes(axis_name):
        mesh = _bound(name)
        if mesh.shape[name] == 1:
            continue
        sent, back = _host_staged(mesh, out)
        for t in sent:
            dist.all_reduce(t, op=op, group=mesh.group(name))
        out = [back(t, like) for t, like in zip(sent, out)]
    return _rebuild(x, out)


def psum(x, axis_name):
    """Sum over the ranks of ``axis_name`` (a name or a tuple of names)."""
    return _all_reduce(x, axis_name, dist.ReduceOp.SUM)


def pmax(x, axis_name):
    return _all_reduce(x, axis_name, dist.ReduceOp.MAX)


def pmean(x, axis_name):
    n = axis_size(axis_name)
    total = psum(x, axis_name)
    return _rebuild(total, [t / n for t in _leaves(total)])


def _all_gather_leaf(mesh: Mesh, name: str, t: torch.Tensor
                     ) -> List[torch.Tensor]:
    if mesh.shape[name] == 1:
        return [t]
    (sent,), back = _host_staged(mesh, [t])
    parts = [torch.empty_like(sent) for _ in range(mesh.shape[name])]
    dist.all_gather(parts, sent, group=mesh.group(name))
    return [back(p, t) for p in parts]


def all_gather(x, axis_name: str, *, axis: int = 0, tiled: bool = False):
    """``lax.all_gather``: every rank's ``x`` by axis index, stacked on a
    new dimension ``axis`` or, ``tiled``, concatenated along ``axis``."""
    mesh = _bound(axis_name)
    out = []
    for t in _leaves(x):
        parts = _all_gather_leaf(mesh, axis_name, t)
        out.append(torch.cat(parts, dim=axis) if tiled
                   else torch.stack(parts, dim=axis))
    return _rebuild(x, out)


def psum_scatter(x, axis_name: str, *, scatter_dimension: int = 0,
                 tiled: bool = False):
    """``lax.psum_scatter``: the sum over the axis, of which this rank
    keeps block ``axis_index`` along ``scatter_dimension`` (``tiled``; else
    that dimension has the axis's size and is dropped). One
    reduce-scatter per leaf."""
    mesh = _bound(axis_name)
    D, sd = mesh.shape[axis_name], scatter_dimension
    out = []
    for t in _leaves(x):
        if t.shape[sd] % D if tiled else t.shape[sd] != D:
            raise ValueError(f"psum_scatter: dimension {sd} of "
                             f"{tuple(t.shape)} does not split over {D} "
                             "ranks")
        if D == 1:
            part = t.clone()
        else:
            (sent,), back = _host_staged(mesh, [t.movedim(sd, 0)])
            recv = sent.new_empty((sent.shape[0] // D,) + sent.shape[1:])
            _reduce_scatter(recv, sent, group=mesh.group(axis_name))
            part = back(recv, t).movedim(0, sd)
        out.append(part if tiled else part.squeeze(sd))
    return _rebuild(x, out)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               tiled: bool = False):
    """``lax.all_to_all``: split ``x`` along ``split_axis`` into one block
    per rank of the axis, send block ``j`` to axis index ``j``, and join
    the blocks received, by source index, along ``concat_axis``
    (concatenated when ``tiled``, else stacked with the split axis
    dropped)."""
    mesh = _bound(axis_name)
    D = mesh.shape[axis_name]
    out = []
    for t in _leaves(x):
        if t.shape[split_axis] % D:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(t.shape)} does not split over {D} "
                             "ranks")
        blocks = list(t.chunk(D, dim=split_axis))
        if D > 1:
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
    return _rebuild(x, out)
