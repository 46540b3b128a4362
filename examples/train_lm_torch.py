"""LM training example on the PyTorch port: trains a reduced-config model
from the arch zoo with the whole training stack on one device — the
train step (autograd through the plain versions, AdamW with its
warmup-cosine schedule), the deterministic token pipeline, asynchronous
checkpoints, the straggler watchdog, preemption handling and resume.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-1.5b \\
        --steps 200 --device cpu

(The full-width model is ``TrainLoopConfig(reduced=False)`` on the card;
the entry point is ``repro_torch.launch.train`` either way.)
"""
import argparse
import tempfile

from repro_torch.launch.train import TrainLoopConfig, train


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2-1.5b")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs there)")
    args = p.parse_args()
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")

    out = train(TrainLoopConfig(
        arch=args.arch, steps=args.steps, seq_len=128, global_batch=8,
        ckpt_dir=ckpt, ckpt_every=50, reduced=True, mesh_shape=(1, 1),
        device=args.device))
    first = out["losses"][0] if out["losses"] else float("nan")
    print(f"loss {first:.3f} -> {out['final_loss']:.3f} over "
          f"{out['last_step']} steps; checkpoints in {ckpt}")
    assert out["final_loss"] < first, "training did not reduce the loss"


if __name__ == "__main__":
    main()
