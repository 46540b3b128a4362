"""The port's training loop: config, mesh, the train step (one device
or sharded), the token pipeline, checkpointing, fault tolerance and
elastic restart — the JAX package's ``repro.launch.train`` (on the card
unless ``device="cpu"``).

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 200 \
        --ckpt-dir /tmp/ckpt [--reduced | --full] [--mesh 2x2] \
        [--device cpu]

The loop is the reference's: resume from the latest checkpoint, a
straggler watchdog over step times, a non-blocking checkpoint every
``ckpt_every`` steps, a blocking one at a preemption (SIGTERM) and at
the end.

``mesh_shape`` None or ``(1, 1)`` trains on one device (the port's
default; the reference's None is its production mesh, here
``mesh_shape=(16, 16)``). Any other ``(data, model)`` shape trains on a
mesh (`build_mesh`): `train` then runs on every rank of an initialised
default process group of ``data * model`` ranks (another size raises),
each rank reading its rows of the batch (`runtime.elastic.replan_data`)
and holding its blocks of the state (`launch.steps`). The CLI's
``--mesh`` starts the ranks itself (`launch.mesh.run_ranks`: gloo on the
CPU and where ranks share a card, NCCL where each has its own); under
``torchrun`` (``RANK``, ``WORLD_SIZE`` set) it joins the group torchrun
describes instead:

    torchrun --nnodes 32 --nproc-per-node 8 -m repro_torch.launch.train \
        --arch qwen2-1.5b --full --mesh 16x16 Rank 0 alone
emits the log; the returned dict is the same on every rank. A checkpoint
holds whole arrays, so a run resumes on another mesh or on one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.types import resolve_device
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.distributed import pmax
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch.mesh import batch_shard, make_mesh, run_ranks
from repro_torch.launch.steps import AdamWConfig, make_train_step
from repro_torch.models import init_model
from repro_torch.models.transformer import CausalLM
from repro_torch.optim import zero_specs
from repro_torch.runtime import PreemptionHandler, StepWatchdog
from repro_torch.runtime.elastic import replan_data


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
        cfg = dataclasses.replace(
            reduced_config(cfg), tp_size=(loop_cfg.mesh_shape or (1, 1))[1])
    return cfg


def _on_mesh(loop_cfg: TrainLoopConfig) -> bool:
    return (loop_cfg.mesh_shape is not None
            and math.prod(loop_cfg.mesh_shape) > 1)


def build_mesh(loop_cfg: TrainLoopConfig):
    """The ("data", "model") mesh of ``loop_cfg.mesh_shape`` on the ranks
    of the default process group (None for one device)."""
    if not _on_mesh(loop_cfg):
        return None
    return make_mesh(loop_cfg.mesh_shape, ("data", "model"))


def plan_opt_specs(cfg, mesh, param_specs, params):
    """The moments' specs of ``params`` (a dict of tensors or a model) on
    ``mesh``: ``zero_specs`` of the mesh-adapted parameter specs, as the
    reference's."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return zero_specs(shard_lib.adapt_specs_for_mesh(param_specs, mesh),
                      dict(mesh.shape), params)


def train(loop_cfg: TrainLoopConfig, emit=print, *,
          model: Optional[CausalLM] = None) -> dict:
    """Train ``loop_cfg.arch`` for ``loop_cfg.steps`` steps from
    ``model`` (default `init_model` from ``loop_cfg.seed``; on one device
    trained in place, on a mesh the rank's whole copy, which the step
    then uses to compute) or from the latest checkpoint in ``ckpt_dir``.
    Returns the reference's dict: ``final_loss``, ``losses`` (this call's
    steps), ``last_step`` and ``straggler_reports``."""
    mesh = build_mesh(loop_cfg)
    device = resolve_device(loop_cfg.device)
    cfg = loop_model_config(loop_cfg)
    pipeline = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=loop_cfg.seq_len,
        global_batch=loop_cfg.global_batch, seed=loop_cfg.seed))
    rows = loop_cfg.global_batch
    shardings = None
    if mesh is not None:
        if mesh.rank != 0:
            emit = lambda *_: None  # noqa: E731  (rank 0 emits the log)
        hosts, host = batch_shard(mesh)    # this rank's rows
        pipeline = replan_data(pipeline, hosts, host)
        rows //= hosts

    mgr = (CheckpointManager(loop_cfg.ckpt_dir)
           if loop_cfg.ckpt_dir else None)
    watchdog = StepWatchdog()
    preempt = PreemptionHandler().install()
    try:
        plan = make_train_step(
            cfg, mesh, ShapeConfig("loop", loop_cfg.seq_len,
                                   loop_cfg.global_batch, "train"),
            opt_cfg=AdamWConfig(lr=loop_cfg.lr), total_steps=loop_cfg.steps,
            warmup_steps=loop_cfg.warmup_steps, sequence_parallel=False)
        if model is None:
            model = init_model(cfg, loop_cfg.seed, device=device)
        state = plan.init_state(model)
        if mesh is not None:
            shardings = plan.state_shardings()

        start_step = 0
        if mgr is not None and mgr.latest_step() is not None:
            start_step = mgr.latest_step()
            state = mgr.restore(state, start_step, shardings=shardings)
            emit(f"[train] resumed from step {start_step}")

        losses = []
        t_last = time.perf_counter()
        step = start_step
        for step in range(start_step, loop_cfg.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipeline.batch_at(step).items()}
            if cfg.encoder_layers:
                batch["enc_emb"] = torch.zeros(
                    (rows, cfg.encoder_seq_len, cfg.d_model),
                    dtype=torch.float32, device=device)
            state, metrics = plan(state, batch)
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
                mgr.save(step + 1, state, blocking=False,
                         shardings=shardings)
            if _agreed(mesh, preempt.preemption_requested, device):
                emit(f"[train] preemption at step {step}; checkpointing")
                if mgr is not None:
                    mgr.save(step + 1, state, blocking=True,
                             shardings=shardings)
                break
        if mgr is not None:
            mgr.save(step + 1, state, blocking=True, shardings=shardings)
            mgr.wait()
    finally:
        preempt.uninstall()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "last_step": step + 1,
            "straggler_reports": _agreed(mesh, len(watchdog.reports),
                                         device, as_int=True)}


def _agreed(mesh, value, device, *, as_int: bool = False):
    """``value`` (a bool or a count) taken as the largest over the
    mesh's ranks, so that every rank decides alike."""
    if mesh is None:
        return value
    with mesh:
        out = pmax(torch.tensor(float(value), device=device),
                   mesh.axis_names)
    return int(out) if as_int else bool(out)


def _train_rank(ctx, loop_cfg: TrainLoopConfig) -> dict:
    """A rank of the CLI's ``--mesh`` run (`run_ranks`)."""
    return train(loop_cfg)


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
                   help="DATAxMODEL, e.g. '2x2': that many ranks started "
                        "here, unless a process group is up already "
                        "(default: one device)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs there)")
    args = p.parse_args(argv)
    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    loop_cfg = TrainLoopConfig(
        arch=args.arch, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, reduced=args.reduced,
        mesh_shape=mesh_shape, lr=args.lr, device=args.device)
    dist = torch.distributed
    if _on_mesh(loop_cfg) and not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            # Started by torchrun: one process per card, the group from
            # its environment.
            on_card = args.device != "cpu" and torch.cuda.is_available()
            if on_card:
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group("nccl" if on_card else "gloo")
            try:
                out = train(loop_cfg)
            finally:
                dist.destroy_process_group()
        else:
            out = run_ranks(_train_rank, math.prod(mesh_shape), loop_cfg,
                            device="cpu" if args.device == "cpu" else None)[0]
    else:
        out = train(loop_cfg)
    print(f"[train] done: {out['last_step']} steps, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
