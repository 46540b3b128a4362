"""Top operations of one (arch x shape) cell of the PyTorch port, from its
step count: the twin of ``scripts/profile_cell.py`` for
``repro_torch``. It traces one rank's step of the cell on the production
mesh (an `AbstractMesh`: no devices) on ``meta`` tensors
(`repro_torch.launch.cost`) and prints the operations that move the most
HBM bytes, those that do the most FLOPs (the hand-written kernels by
their formulas), and the collectives, each summed over its calls.

    PYTHONPATH=src python scripts/profile_cell_torch.py \
        deepseek-moe-16b train_4k
    PYTHONPATH=src python scripts/profile_cell_torch.py \
        qwen2-1.5b decode_32k --multi-pod
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.cost import count_cell
from repro_torch.launch.dryrun import production_mesh
from repro_torch.launch.steps import make_cell_plan


def profile(arch: str, shape_name: str, top: int = 15,
            multi_pod: bool = False) -> None:
    plan = make_cell_plan(get_config(arch), production_mesh(multi_pod),
                          SHAPES[shape_name])
    summary, counter = count_cell(plan)
    ops = [(name, shapes, *rec) for (name, shapes), rec in
           counter.by_op.items() if not name.startswith("collective")]
    for title, key, total, unit in (
            ("TOP HBM TRAFFIC", 4, summary["hbm_bytes"], "B"),
            ("TOP FLOPS", 3, summary["flops"], "F")):
        print(f"\n=== {title} (total {total:.3e} {unit}/chip) ===")
        for name, shapes, calls, flops, nbytes in sorted(
                ops, key=lambda r: r[key], reverse=True)[:top]:
            print(f"  {(flops, nbytes)[key - 3]:.3e}  x{calls:<7g} "
                  f"{name:<32} {shapes[:60]}")
    coll = summary["collective_bytes"]
    print(f"\n=== TOP COLLECTIVES (total {coll['total']:.3e} B/chip, "
          "output bytes) ===")
    for kind, nbytes in sorted(coll.items(), key=lambda kv: -kv[1]):
        calls = counter.by_op.get((f"collective {kind}", ""), [0])[0]
        if kind != "total" and nbytes > 0:
            print(f"  {nbytes:.3e}  x{calls:<7g} {kind}")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("arch")
    p.add_argument("shape", choices=sorted(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--top", type=int, default=15)
    a = p.parse_args()
    profile(a.arch, a.shape, a.top, a.multi_pod)
