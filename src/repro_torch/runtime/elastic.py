"""Elastic scaling: reshard a training state onto a new mesh and re-split
the data stream, the JAX package's ``repro.runtime.elastic``.

The contract: checkpoints and the deterministic data pipeline are the
source of truth. On a topology change (a node lost or added) the job
restarts with a new mesh; `reshard_state` cuts every leaf to the new
mesh's blocks (shapes do not depend on the mesh, only placements do),
and `replan_data` re-slices the global batch over the ranks that hold
the data rows. A checkpoint written on one mesh restores onto any other
through ``CheckpointManager.restore(shardings=shardings_for(...))``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import (NamedSharding, P, entry_axes, map_specs,
                                     tree_map)


def shardings_for(mesh, specs: Any) -> Any:
    """Spec pytree -> `NamedSharding` pytree on ``mesh``, dropping axis
    names the new mesh does not have (e.g. 'pod' after a shrink)."""
    axes = set(mesh.axis_names)

    def fix(spec) -> NamedSharding:
        entries = []
        for e in spec:
            kept = tuple(a for a in entry_axes(e) if a in axes)
            if e is None or not kept:
                entries.append(None)
            elif isinstance(e, str):
                entries.append(e)
            else:
                entries.append(kept)
        return NamedSharding(mesh, P(*entries))

    return map_specs(fix, specs)


def _tree(state):
    """``state`` with every module as the dict of its parameters."""
    return tree_map(lambda x: dict(x.named_parameters()) if isinstance(
        x, torch.nn.Module) else x, state,
        is_leaf=lambda x: isinstance(x, (torch.nn.Module, torch.Tensor)))


def reshard_state(state: Any, new_mesh, specs: Any) -> Any:
    """Every leaf of ``state`` (whole tensors; a module counts as the dict
    of its parameters) cut to this rank's block on ``new_mesh`` under
    ``specs`` (a spec pytree shaped like ``state``), as new tensors."""
    new = shardings_for(new_mesh, specs)

    def one(sh: NamedSharding, leaf):
        with torch.no_grad():
            return sh.block(leaf).clone()

    return map_shardings(one, new, _tree(state))


def map_shardings(fn, shardings, *others):
    """`tree_map` over the `NamedSharding` leaves of ``shardings``."""
    return tree_map(fn, shardings, *others,
                    is_leaf=lambda x: isinstance(x, NamedSharding))


def replan_data(pipeline, num_hosts: int, host_id: int):
    """Re-split the deterministic token stream over a new host set."""
    return pipeline.reshard(num_hosts, host_id)
