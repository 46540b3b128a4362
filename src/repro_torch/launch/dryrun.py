"""The dry-run of every (architecture x input-shape x mesh) cell: the
twin of the JAX package's ``repro.launch.dryrun``, for the port on
NVIDIA H100s.

For each cell it builds the production mesh as an `AbstractMesh` (16 x
16 = 256 chips, or 2 x 16 x 16 = 512 with ``--multi-pod``): axis sizes
alone, so it needs no process group, no host devices and no card. It
makes the cell's plan (`launch.steps.make_cell_plan`), counts its
resident bytes per chip (`CellPlan.per_chip_argument_bytes`, the
reference's count) and the parameter bytes of the rank's compute model
(`CellPlan.compute_param_bytes`: the "model" block of a tensor-parallel
dense, hybrid or encoder-decoder model, the whole model for the families
that run replicated over "model"), traces one rank's step on ``meta`` tensors
(`launch.cost.count_cell`: FLOPs, HBM bytes and collective bytes per
chip; nothing allocated) and writes the roofline at the card's peaks
(`launch.roofline`). ``fits_h100_80gb`` holds where the step's
arguments, its compute model and, in training, that model's gradients
fit the card's 80 GB (activations are not counted). A cell the
architecture does not support is ``skipped`` with the config's reason;
a cell that raises is ``failed``, and the run exits non-zero.

Usage (``PYTHONPATH=src``, on the CPU):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from repro_torch.configs import ALL_SHAPES, SHAPES, get_config, list_configs
from repro_torch.distributed import AbstractMesh
from repro_torch.launch.cost import count_cell
from repro_torch.launch.roofline import (H100_MEMORY_BYTES, format_table,
                                         roofline_report)
from repro_torch.launch.steps import make_cell_plan


def production_mesh(multi_pod: bool) -> AbstractMesh:
    """The reference's production mesh, as axis sizes."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    mesh = production_mesh(multi_pod)
    t0 = time.perf_counter()
    plan = make_cell_plan(cfg, mesh, shape)
    arg_bytes = plan.per_chip_argument_bytes()
    compute_bytes = plan.compute_param_bytes()
    cost, _ = count_cell(plan)
    trace_s = time.perf_counter() - t0
    tp = mesh.shape["model"]
    # The arguments, the compute model and, in training, its gradients.
    step_bytes = arg_bytes + compute_bytes * (2 if shape.kind == "train"
                                              else 1)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "kind": shape.kind, "chips": mesh.size,
        "trace_s": round(trace_s, 2),
        "flops": cost["flops"], "hbm_bytes": cost["hbm_bytes"],
        "collective_bytes": cost["collective_bytes"],
        "kernel_calls": cost["kernels"],
        "tensor_parallel": plan.tensor_parallel,
        "memory": {"per_chip_argument_bytes": arg_bytes,
                   "compute_param_bytes": compute_bytes,
                   "step_bytes": step_bytes},
    }
    if not plan.tensor_parallel:
        # This family runs its dense layers whole on every rank of a
        # "model" line, where the reference's GSPMD splits their matmuls
        # over it: its per-chip FLOPs are up to "model" times the
        # reference's.
        result["replicated_over_model"] = tp
        result["flops_split_over_model"] = cost["flops"] / tp
    result["roofline"] = roofline_report(cfg, shape, result)
    fits = step_bytes < H100_MEMORY_BYTES
    result["fits_h100_80gb"] = bool(fits)
    if verbose:
        rl = result["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"(trace {trace_s:.1f} s)")
        print(f"  per-chip argument bytes: {arg_bytes} "
              f"({arg_bytes / 1e9:.2f} GB); compute model's parameters "
              f"per rank: {compute_bytes} ({compute_bytes / 1e9:.2f} GB, "
              f"{'tensor-parallel' if plan.tensor_parallel else 'replicated'}"
              f" over model={tp}); with them"
              f"{' and their gradients' if shape.kind == 'train' else ''}"
              f" {step_bytes / 1e9:.2f} GB: "
              f"{'fits' if fits else 'DOES NOT FIT'} the H100's 80 GB")
        split = ("" if plan.tensor_parallel else
                 f" (dense FLOPs replicated over model={tp}: "
                 f"{cost['flops'] / tp:.4e} if split)")
        print(f"  per chip: flops={cost['flops']:.4e} "
              f"hbm_bytes={cost['hbm_bytes']:.4e}{split}")
        print("  collective_bytes:", {k: f"{v:.3e}" for k, v in
                                      cost["collective_bytes"].items()
                                      if v})
        print(f"  roofline: compute {rl['compute_s']:.3e} s, memory "
              f"{rl['memory_s']:.3e} s, collective {rl['collective_s']:.3e}"
              f" s, {rl['dominant']}; model_flops {rl['model_flops']:.4e},"
              f" useful {rl['useful_flops_ratio']}, roofline fraction "
              f"{rl['roofline_fraction']}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", type=str, default=None)
    p.add_argument("--shape", type=str, default=None,
                   choices=[s.name for s in ALL_SHAPES])
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true",
                   help="use the 2x16x16 mesh (default: 16x16)")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if args.all:
        archs = sorted(list_configs())
        shapes = [s.name for s in ALL_SHAPES]
    elif args.arch is None:
        p.error("name an --arch or pass --all")
    else:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else [s.name for s in
                                                  ALL_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.perf_counter()
    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_cell(arch, shape, mp))
                except Exception as e:  # noqa: BLE001 (a cell's failure)
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": "2x16x16" if mp else "16x16",
                                    "status": "failed", "error": repr(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"[dryrun] wrote {len(results)} cells to {args.out}")
    print(format_table(results))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    print(f"[dryrun] {n_ok} ok, {n_skip} skipped (documented), "
          f"{len(failures)} failed in {time.perf_counter() - t0:.1f} s")
    for f in failures:
        print("  FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
