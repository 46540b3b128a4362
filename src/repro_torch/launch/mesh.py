"""Building meshes and starting their ranks: the counterpart of the JAX
package's ``repro.launch.mesh``.

A mesh (`repro_torch.distributed.Mesh`) is a set of SPMD ranks of
``torch.distributed`` with named axes, and the reference's ``lax``
collectives run over the ambient one (`repro_torch.distributed`).
"Inside ``shard_map``" becomes "inside ``with mesh:`` on a rank of that
mesh":

    def body(ctx):                              # runs on every rank
        mesh = make_debug_mesh(1, 4)
        with mesh:
            h = linear_recurrence_scan(a_local, b_local, axis_name="model")

    results = run_ranks(body, 4)                # [rank 0's, ..., rank 3's]

`run_ranks` starts the ranks with ``torch.multiprocessing`` (spawned for
the card, forked from a server that has imported torch on the CPU) and a
``FileStore`` rendezvous in a private temporary directory; each rank's
device is ``cuda:{rank % device_count}`` unless the caller passes
``device="cpu"``. Backends: NCCL where every rank has a card of its own;
gloo on the CPU and where ranks share a card (NCCL refuses two ranks of
one communicator on one device; CUDA tensors then go through the host).
`run_ranks` prints its choice. On a real cluster, start one process per
card with ``torchrun --nnodes N --nproc-per-node 8 script.py`` instead: it
sets ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``, the
script calls ``torch.distributed.init_process_group("nccl")`` and then
builds its mesh with `make_production_mesh` or `make_mesh`.
"""
from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import Mesh

#: How long a rank waits in any collective before it fails.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    return Mesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: 16 x 16 ("data", "model"), or 2
    x 16 x 16 ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ("data", "model") mesh, e.g. for four ranks on one card."""
    return make_mesh((data, model), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_shard(mesh: Mesh) -> tuple:
    """(the number of batch shards, this rank's shard): the row-major
    index of its coordinates on the batch axes the mesh has."""
    count, index = 1, 0
    for a in batch_axes(mesh):
        if a in mesh.shape:
            count *= mesh.shape[a]
            index = index * mesh.shape[a] + mesh.coords[a]
    return count, index


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

class RankContext(NamedTuple):
    """What a rank's function is told: its rank, the number of ranks, its
    device and the process group's backend."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def _choose_backend(nprocs: int, device: Optional[str]) -> str:
    """gloo on the CPU and where ranks share a card; NCCL where every rank
    has a card of its own."""
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device; pass device='cpu' "
                           "to run the ranks on the CPU")
    return "nccl" if nprocs <= torch.cuda.device_count() else "gloo"


class _Caller:
    """What a rank forked from the server takes over from the caller of
    `run_ranks`, as a spawned rank would have it: the working directory,
    the environment, ``sys.path``, and stdout and stderr (file descriptors
    passed to the rank as it starts)."""

    def __reduce__(self):
        from multiprocessing import reduction

        return _Caller._received, (os.getcwd(), dict(os.environ),
                                   list(sys.path), reduction.DupFd(1),
                                   reduction.DupFd(2))

    @staticmethod
    def _received(cwd, environ, path, out, err) -> "_Caller":
        caller = _Caller()
        caller.state = cwd, environ, path, out, err
        return caller

    def adopt(self) -> None:
        cwd, environ, path, out, err = self.state
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(environ)
        sys.path[:] = path
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, dup in ((1, out.detach()), (2, err.detach())):
            os.dup2(dup, fd)
            os.close(dup)


def _rank_main(rank: int, nprocs: int, store_path: str,
               device: Optional[str], backend: str, out_dir: str,
               caller: Optional[_Caller]) -> None:
    if caller is not None:
        caller.adopt()
    fn, args = torch.load(os.path.join(out_dir, "call.pt"),
                          weights_only=False)
    if device == "cpu":
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, nprocs)
    kw = dict(store=store, rank=rank, world_size=nprocs,
              timeout=COLLECTIVE_TIMEOUT)
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    try:
        result = fn(RankContext(rank, nprocs, dev, backend), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, nprocs: int, *args, device: Optional[str] = None,
              emit: Optional[Callable[[str], None]] = print) -> List[Any]:
    """Run ``fn(ctx, *args)`` on ``nprocs`` ranks (`RankContext`) and
    return each rank's result, by rank.

    ``fn`` and ``args`` go to the ranks (new processes) through a file
    that each reads once it has started, so ``fn`` is a module-level
    function (handed over through the start pipe instead, large arguments
    would hold each rank's start until the one before it had imported
    ``fn``'s module); each result comes back through ``torch.save``, so
    tensors in it are best moved to the CPU first.
    ``device``: ``"cpu"`` (gloo, one torch thread per rank) or None, the
    card (``cuda:{rank % device_count}``; NCCL where the ranks have a card
    each, else gloo). `COLLECTIVE_TIMEOUT` bounds every collective.
    A rank that raises makes this raise with its traceback, after the
    other ranks are stopped."""
    import torch.multiprocessing as mp

    backend = _choose_backend(nprocs, device)
    if emit is not None:
        where = ("the CPU" if device == "cpu" else
                 f"{min(nprocs, torch.cuda.device_count())} card(s)")
        why = {"nccl": "one card per rank",
               "gloo": ("CPU tensors" if device == "cpu" else
                        "ranks share a card, which NCCL refuses; CUDA "
                        "tensors are staged through the host")}[backend]
        emit(f"[mesh] {nprocs} ranks on {where}, backend {backend} "
             f"({why})")
    if device == "cpu":
        # Ranks forked from one server that has imported torch and
        # torch._dynamo (which the blocks' remat, torch.utils.checkpoint,
        # imports on its first call): seconds of imports once, not per
        # rank. On the card they are spawned: a process forked after
        # CUDA's initialisation cannot use it.
        mp.set_forkserver_preload(["__main__", "torch", "torch._dynamo"])
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        torch.save((fn, args), os.path.join(tmp, "call.pt"))
        mp.start_processes(
            _rank_main, nprocs=nprocs, join=True,
            start_method="forkserver" if device == "cpu" else "spawn",
            args=(nprocs, os.path.join(tmp, "store"), device, backend,
                  tmp, _Caller() if device == "cpu" else None))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
