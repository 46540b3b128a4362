"""The port's training loop: config, the single-device train step,
the token pipeline, checkpointing and fault tolerance — the JAX
package's ``repro.launch.train`` on one device (the card unless
``device="cpu"``).

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 200 \
        --ckpt-dir /tmp/ckpt [--reduced | --full] [--device cpu]

The loop is the reference's: resume from the latest checkpoint, a
straggler watchdog over step times, a non-blocking checkpoint every
``ckpt_every`` steps, a blocking one at a preemption (SIGTERM) and at
the end. A mesh other than one device (``mesh_shape`` None or ``(1,
1)``) waits for ROADMAP A, item 4b, and raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.launch.steps import (AdamWConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import init_model
from repro_torch.models.transformer import CausalLM
from repro_torch.runtime import PreemptionHandler, StepWatchdog


@dataclasses.dataclass
class TrainLoopConfig:
    arch: str
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    reduced: bool = True
    mesh_shape: Optional[tuple] = None   # None or (1, 1): one device
    lr: float = 3e-4
    warmup_steps: int = 20
    seed: int = 0
    device: Optional[str] = None         # the card unless "cpu"


def loop_model_config(loop_cfg: TrainLoopConfig):
    cfg = get_config(loop_cfg.arch)
    if loop_cfg.reduced:
        cfg = dataclasses.replace(reduced_config(cfg), tp_size=1)
    return cfg


def train(loop_cfg: TrainLoopConfig, emit=print, *,
          model: Optional[CausalLM] = None) -> dict:
    """Train ``loop_cfg.arch`` for ``loop_cfg.steps`` steps from
    ``model`` (default `init_model` from ``loop_cfg.seed``; trained in
    place) or from the latest checkpoint in ``ckpt_dir``. Returns the
    reference's dict: ``final_loss``, ``losses`` (this call's steps),
    ``last_step`` and ``straggler_reports``."""
    mesh = loop_cfg.mesh_shape
    if mesh is not None and tuple(mesh) != (1, 1):
        raise ValueError(
            f"mesh_shape {tuple(mesh)}: the port trains on one device (None "
            "or (1, 1)); a mesh waits for ROADMAP A, item 4b (training "
            "across a mesh)")
    device = resolve_device(loop_cfg.device)
    cfg = loop_model_config(loop_cfg)
    pipeline = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=loop_cfg.seq_len,
        global_batch=loop_cfg.global_batch, seed=loop_cfg.seed))

    mgr = (CheckpointManager(loop_cfg.ckpt_dir)
           if loop_cfg.ckpt_dir else None)
    watchdog = StepWatchdog()
    preempt = PreemptionHandler().install()
    try:
        step_fn = make_train_step(cfg, AdamWConfig(lr=loop_cfg.lr),
                                  total_steps=loop_cfg.steps,
                                  warmup_steps=loop_cfg.warmup_steps)
        if model is None:
            model = init_model(cfg, loop_cfg.seed, device=device)
        state = init_train_state(model)

        start_step = 0
        if mgr is not None and mgr.latest_step() is not None:
            state = mgr.restore(state)
            start_step = mgr.latest_step()
            emit(f"[train] resumed from step {start_step}")

        losses = []
        t_last = time.perf_counter()
        step = start_step
        for step in range(start_step, loop_cfg.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipeline.batch_at(step).items()}
            if cfg.encoder_layers:
                batch["enc_emb"] = torch.zeros(
                    (loop_cfg.global_batch, cfg.encoder_seq_len,
                     cfg.d_model), dtype=torch.float32, device=device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            now = time.perf_counter()
            report = watchdog.observe(step, now - t_last)
            if report is not None:
                emit(f"[train] straggler step {step}: "
                     f"{report.duration:.3f}s ({report.ratio:.1f}x EMA)")
            t_last = now
            if step % loop_cfg.log_every == 0:
                emit(f"[train] step {step} loss {loss:.4f} "
                     f"gnorm {float(metrics['grad_norm']):.3f}")
            if mgr is not None and (step + 1) % loop_cfg.ckpt_every == 0:
                mgr.save(step + 1, state, blocking=False)
            if preempt.preemption_requested:
                emit(f"[train] preemption at step {step}; checkpointing")
                if mgr is not None:
                    mgr.save(step + 1, state, blocking=True)
                break
        if mgr is not None:
            mgr.save(step + 1, state, blocking=True)
            mgr.wait()
    finally:
        preempt.uninstall()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "last_step": step + 1,
            "straggler_reports": len(watchdog.reports)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--mesh", type=str, default=None,
                   help="'1x1' (one device, the default); any other mesh "
                        "raises until ROADMAP A, item 4b")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs there)")
    args = p.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    out = train(TrainLoopConfig(
        arch=args.arch, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, reduced=args.reduced,
        mesh_shape=mesh_shape, lr=args.lr, device=args.device))
    print(f"[train] done: {out['last_step']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
