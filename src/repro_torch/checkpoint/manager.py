"""Sharded checkpointing: per-leaf ``.npy`` payloads + a JSON manifest,
atomic commit, asynchronous writes with at most one in flight, and
restore onto a *different* mesh or sharding (elastic restart) — the JAX
package's ``repro.checkpoint.manager``.

Layout (the reference's):
  <dir>/step_<N>.tmp/...   (staging)
  <dir>/step_<N>/manifest.json + leaf_<i>.npy  (committed via rename)

A state is any nesting of dicts, lists, tuples (named tuples too) and
``nn.Module``s (their ``named_parameters()``) over tensors. numpy has no
bfloat16, so a bfloat16 leaf is stored as its ``uint16`` bit pattern
with ``"bfloat16"`` in the manifest: the round trip is bit-exact and
needs no ``ml_dtypes``. `restore` copies into the tensors of a state like
the saved one, in place (the reference returns new arrays), so a model's
parameters stay the model's.

On a mesh a state's leaves are the rank's blocks, and ``shardings`` (a
pytree of `repro_torch.distributed.NamedSharding` shaped like the state,
e.g. ``TrainPlan.state_shardings()``) says how. `save` then runs on every
rank at once: it gathers each leaf to its full array, rank 0 writes it in
the one-device format, and every rank waits for the commit (at once, or
at `wait` for a non-blocking save). `restore(shardings=)` reads each full
array and keeps the rank's block, with no exchange. So a checkpoint
written on any mesh restores onto any other mesh, and onto one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import NamedSharding


def _is_sharding(x) -> bool:
    return x is None or isinstance(x, NamedSharding)


def _flatten_with_names(tree, prefix: str = "", is_leaf=None
                        ) -> List[Tuple[str, Any]]:
    """``(name, tensor)`` for every leaf, the keys joined by "/" (with
    ``is_leaf``, its leaves instead of tensors: shardings)."""
    if (is_leaf(tree) if is_leaf is not None
            else isinstance(tree, torch.Tensor)):
        return [(prefix, tree)]
    if isinstance(tree, torch.nn.Module):
        items = list(tree.named_parameters())
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"checkpoint: cannot flatten {type(tree).__name__} "
                        f"at {prefix or '<root>'!r}")
    out = []
    for key, sub in items:
        out += _flatten_with_names(sub, f"{prefix}/{key}" if prefix
                                   else str(key), is_leaf)
    return out


def _shardings_by_name(state, shardings) -> dict:
    """``{leaf name: NamedSharding or None}``, ``shardings`` flattened
    alike ``state`` (None: every leaf whole)."""
    if shardings is None:
        return {}
    if isinstance(shardings, torch.nn.Module):
        raise TypeError("shardings: a pytree of NamedSharding, not a model")
    return dict(_flatten_with_names(shardings, is_leaf=_is_sharding))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy even on the CPU: training goes on
    updating the state in place while a write is in flight)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._ranks = False     # a save from a mesh awaits its barrier

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = True,
             shardings: Any = None) -> str:
        """Write checkpoint for ``step``. With ``blocking=False`` the
        device->host copy happens now, the file I/O in the background.
        With ``shardings`` (module docstring) every rank calls it: the
        leaves are gathered whole and rank 0 writes them."""
        flat = _flatten_with_names(state)
        by_name = _shardings_by_name(state, shardings)
        mesh = next((sh.mesh for sh in by_name.values() if sh is not None),
                    None)
        writer = mesh is None or mesh.rank == 0
        names, dtypes, host_leaves = [], [], []
        for n, t in flat:
            sh = by_name.get(n)
            full = sh.gather(t) if sh is not None else t
            names.append(n)
            dtypes.append("bfloat16" if t.dtype == torch.bfloat16 else None)
            # D2H copy (rank 0's; the other ranks only took part)
            host_leaves.append(_to_host(full) if writer else None)
            del full
        if self._thread is not None:
            self._thread.join()  # double-buffer: at most one in flight
            self._thread = None

        def _write():
            self._write(step, names, dtypes, host_leaves)

        if writer:
            if blocking:
                _write()
            else:
                self._thread = threading.Thread(target=_write, daemon=True)
                self._thread.start()
        if mesh is not None:
            self._ranks = True
            if blocking:
                self.wait()
        return self.path_for(step)

    def wait(self):
        """Wait for the write in flight; after a save from a mesh, every
        rank calls it and returns once rank 0 has committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._ranks:
            self._ranks = False
            if dist.is_available() and dist.is_initialized():
                dist.barrier()

    def _write(self, step: int, names, dtypes, host_leaves):
        final = self.path_for(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, dt, arr) in enumerate(zip(names, dtypes,
                                                host_leaves)):
            fn = f"leaf_{i}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"name": name, "file": fn, "shape": list(arr.shape),
                 "dtype": dt or str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    # ------------------------------------------------------------------
    def restore(self, state_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore checkpoint ``step`` (default the latest) into
        ``state_like``: every leaf is found by name and checked for its
        shape before any is written, then copied into the matching tensor
        in place, onto its device and into its dtype. With ``shardings``
        (module docstring) a leaf is this rank's block of the saved array
        under its sharding, which may be on any mesh. Returns
        ``state_like``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.path_for(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        shards = _shardings_by_name(state_like, shardings)
        loaded = []
        for name, like in _flatten_with_names(state_like):
            entry = by_name.get(name)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            arr = np.load(os.path.join(path, entry["file"]))
            t = _from_host(arr, entry["dtype"])
            sh = shards.get(name)
            if sh is not None:
                t = sh.block(t)
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{tuple(t.shape)} vs {tuple(like.shape)}"
                                 + (f" (the block under {sh})" if sh
                                    is not None else ""))
            loaded.append((like, t))
        with torch.no_grad():
            for like, t in loaded:
                like.copy_(t)
        return state_like

    # ------------------------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.path_for(s), ignore_errors=True)
