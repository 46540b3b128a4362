"""What one rank of a tensor-parallel serve run on the 2 x 2 mesh holds
and stages, counted on the CPU before the card measures it: the serve
plans of ``chip_smoke.py``'s [train_mesh] (f), (g) and (h) (qwen2-1.5b,
hymba-1.5b and seamless-m4t-medium at full width and depth, global batch
16, a prompt of 64) traced for one rank on ``meta`` tensors on an
`AbstractMesh((2, 2))` (`repro_torch.launch.cost`). For each: the
compute model's bytes per rank against the whole model's, the bytes a
rank stages through the host per decode step and per prefill when the
ranks share a card over gloo (each collective's operand and output
bytes: what `distributed._host_staged` copies), the collectives per
step, the kernel calls by the kernels' formulas, and the bytes the
replicated layout's gathers would stage per decode step instead.

    PYTHONPATH=src python scripts/tp_serve_counts_torch.py
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import AbstractMesh  # noqa: E402
from repro_torch.launch import steps as st  # noqa: E402
from repro_torch.launch.cost import Counter, meta_inputs  # noqa: E402


class Staged(Counter):
    """A step count that also sums each collective's operand and output
    bytes and counts the collectives."""

    def __init__(self):
        super().__init__()
        self.staged, self.calls = 0, 0

    def collective(self, kind, out_bytes, in_bytes):
        self.staged += out_bytes + in_bytes
        self.calls += 1
        super().collective(kind, out_bytes, in_bytes)


def staged(plan) -> Staged:
    args, kwargs = meta_inputs(plan)
    counter = Staged()
    with counter:
        plan.step_fn(*args, **kwargs)
    return counter


def main() -> None:
    mesh = AbstractMesh(cs.TRAIN_MESH_SHAPE, ("data", "model"))
    B, Pn = cs.TP_SERVE_B, cs.TP_SERVE_PROMPT
    for path, (arch, S) in cs.TP_SERVE.items():
        cfg = get_config(arch)
        dp = st.make_decode_step(cfg, mesh, ShapeConfig("d", S, B, "decode"))
        pp = st.make_prefill_step(cfg, mesh, ShapeConfig("p", Pn, B,
                                                         "prefill"))
        whole = sum(math.prod(s) * d.itemsize
                    for s, d in dp.param_shapes.values())
        dec, pre = staged(dp), staged(pp)
        print(f"{path} ({arch}, caches of {S}): tensor-parallel "
              f"{dp.tensor_parallel and pp.tensor_parallel}; compute model "
              f"{dp.compute_param_bytes()} of {whole} bytes per rank; "
              f"staged per decode step {dec.staged} bytes in {dec.calls} "
              f"collectives, per prefill {pre.staged} in {pre.calls}; "
              f"kernel calls per decode step "
              f"{dict(dec.summary()['kernels'])}, per prefill "
              f"{dict(pre.summary()['kernels'])}; the replicated layout's "
              f"gathers per decode step "
              f"{cs._parent_serve_bytes(dp, cfg, B, S)} bytes")


if __name__ == "__main__":
    main()
