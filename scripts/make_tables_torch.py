"""Merge the PyTorch port's dry-run JSON outputs
(``python -m repro_torch.launch.dryrun --out``) and print its tables: the
twin of ``scripts/make_tables.py``, with the H100's memory (80 GB) for
the fit and the roofline at the H100's peaks.

    PYTHONPATH=src python scripts/make_tables_torch.py results/*.json
"""
from __future__ import annotations

import json
import sys

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}
KINDS = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
         "all-to-all": "a2a", "collective-permute": "cp"}


def load(paths):
    cells = {}
    for p in paths:
        with open(p) as f:
            for r in json.load(f):
                key = (r["arch"], r["shape"], r["mesh"])
                # Later files win (re-runs of fixed cells).
                if key not in cells or r["status"] == "ok":
                    cells[key] = r
    return sorted(cells.values(),
                  key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9),
                                 r["mesh"]))


def dryrun_table(cells):
    rows = ["| arch | shape | mesh | status | GB/chip (args) | GB/chip "
            "(compute model) | fits 80 GB | trace (s) | collective kinds |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in cells:
        head = f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        if r["status"] == "skipped":
            rows.append(head + "| skipped¹ | — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(head + "| FAILED | — | — | — | — | — |")
            continue
        gb = r["memory"]["per_chip_argument_bytes"] / 1e9
        cgb = r["memory"]["compute_param_bytes"] / 1e9
        kinds = ",".join(KINDS[k] for k, v in r["collective_bytes"].items()
                         if k != "total" and v > 0) or "none"
        rows.append(head + f"| ok | {gb:.2f} | {cgb:.2f} | "
                    f"{'yes' if r.get('fits_h100_80gb') else 'NO'} | "
                    f"{r['trace_s']:.1f} | {kinds} |")
    return "\n".join(rows)


def roofline_table(cells, mesh="16x16"):
    rows = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
            "dominant | useful FLOPs ratio | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for r in cells:
        if r["mesh"] != mesh:
            continue
        head = f"| {r['arch']} | {r['shape']} "
        if r["status"] == "skipped":
            rows.append(head + "| — | — | — | skipped¹ | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(head + "| FAILED | | | | | |")
            continue
        rl = r["roofline"]
        rows.append(
            head + f"| {rl['compute_s']:.3e} | {rl['memory_s']:.3e} "
            f"| {rl['collective_s']:.3e} "
            f"| {rl['dominant'].replace('_s', '')} "
            f"| {rl['useful_flops_ratio']:.3f} "
            f"| {rl['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def summary(cells):
    ok = sum(1 for r in cells if r["status"] == "ok")
    sk = sum(1 for r in cells if r["status"] == "skipped")
    fail = sum(1 for r in cells if r["status"] not in ("ok", "skipped"))
    return f"{ok} ok / {sk} skipped / {fail} failed / {len(cells)} cells"


if __name__ == "__main__":
    cells = load(sys.argv[1:])
    print("## Summary:", summary(cells))
    print()
    print("### Dry-run table")
    print(dryrun_table(cells))
    for mesh in ("16x16", "2x16x16"):
        print()
        print(f"### Roofline table ({mesh}, H100 peaks)")
        print(roofline_table(cells, mesh))
