"""The roofline of a step on one NVIDIA H100: the JAX package's
``repro.launch.roofline`` with the card's peaks.

Three terms per (arch x shape x mesh) cell, from the port's own count of
one rank's step (`launch.cost`: FLOPs, HBM bytes and collective bytes
per chip):

  compute_term    = FLOPs per chip / the peak of the compute dtype
  memory_term     = HBM bytes per chip / `H100_HBM_BYTES_PER_S`
  collective_term = collective bytes per chip / `H100_NVLINK_BYTES_PER_S`

``model_flops`` is the reference's: 6 N_active D for a train step, 2
N_active D for a prefill, 2 N_active B for one decode step.
``useful_flops_ratio`` = model FLOPs / the step's FLOPs over every chip,
and ``roofline_fraction`` the model FLOPs' rate against the peak if the
step ran at its dominant term.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, no
# sparsity; at its 700 W power limit).
#: bfloat16 on the tensor cores, FLOP/s.
H100_BF16_FLOPS = 989e12
#: float32 outside the tensor cores, FLOP/s.
H100_F32_FLOPS = 67e12
#: float64 outside the tensor cores, FLOP/s.
H100_F64_FLOPS = 34e12
#: HBM3 bandwidth, bytes/s.
H100_HBM_BYTES_PER_S = 3.35e12
#: NVLink 4, each way, bytes/s.
H100_NVLINK_BYTES_PER_S = 4.5e11
#: Device memory, bytes (80 GB).
H100_MEMORY_BYTES = 80e9

#: The peak FLOP/s of each compute dtype.
PEAK_FLOPS: Dict[str, float] = {"bfloat16": H100_BF16_FLOPS,
                                "float32": H100_F32_FLOPS,
                                "float64": H100_F64_FLOPS}


def bound_ms(n_bytes: float, n_ops: float, op_dtype: str
             ) -> Tuple[float, str]:
    """The least time of some work on the card, in ms: ``n_bytes`` over
    the HBM bandwidth or ``n_ops`` over the peak of ``op_dtype``,
    whichever is larger, and which it is ("bytes" or "operations")."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[op_dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.seq_len * shape.global_batch
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_report(cfg: ModelConfig, shape: ShapeConfig, cell: dict
                    ) -> dict:
    """The three terms, the dominant one and the useful share of a cell;
    ``cell`` carries the per-chip ``flops``, ``hbm_bytes`` and
    ``collective_bytes`` (with ``total``) and ``chips``."""
    chips = cell["chips"]
    peak = PEAK_FLOPS[cfg.compute_dtype]
    terms = {"compute_s": cell["flops"] / peak,
             "memory_s": cell["hbm_bytes"] / H100_HBM_BYTES_PER_S,
             "collective_s": (cell["collective_bytes"]["total"]
                              / H100_NVLINK_BYTES_PER_S)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    step_time = max(terms.values())
    frac = (mf / chips / peak) / step_time if step_time > 0 else 0.0
    total_flops = cell["flops"] * chips
    return {
        **{k: float(f"{v:.6g}") for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": float(f"{mf:.6g}"),
        "useful_flops_ratio": float(f"{(mf / total_flops):.4g}")
        if total_flops else 0.0,
        "roofline_fraction": float(f"{frac:.4g}"),
    }


def format_table(results: list) -> str:
    """A markdown table of dry-run cells (`launch.dryrun`)."""
    hdr = ("| arch | shape | mesh | compute (s) | memory (s) | "
           "collective (s) | dominant | useful FLOPs | roofline frac |")
    rows = [hdr, "|" + "---|" * 9]
    for r in results:
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        if r["status"] == "skipped":
            rows.append(head + "| — | — | — | skipped | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(head + "| FAILED | | | | | |")
            continue
        rl = r["roofline"]
        rows.append(
            head + f"| {rl['compute_s']:.3e} | {rl['memory_s']:.3e} "
            f"| {rl['collective_s']:.3e} | {rl['dominant'].split('_')[0]} "
            f"| {rl['useful_flops_ratio']:.3f} "
            f"| {rl['roofline_fraction']:.3f} |")
    return "\n".join(rows)
