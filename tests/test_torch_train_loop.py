"""Port parity: the single-device train step and the training loop.

The port's `launch.steps.make_train_step` and `launch.train.train` run on
the CPU against the JAX package's step composed by hand (its body without
the mesh: ``value_and_grad(train_loss)``, ``warmup_cosine(opt.step)``,
``adamw_update``; the JAX trainer itself raises on a one-device mesh,
ROADMAP C), from the same weights (``convert.lm_params``) on the same
token-pipeline batches, over 4 steps of a reduced qwen2 and a reduced
deepseek-moe: per-step loss and ``grad_norm`` at the suite's float32
tolerance. A run resumed from its checkpoint equals the uninterrupted
run; a SIGTERM mid-run checkpoints at ``step + 1`` and the resumed run
goes on as if uninterrupted; a mesh other than one device raises; the
CLI and ``examples/train_lm_torch.py`` run with ``--device cpu``.
"""
import functools
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, STEPS = 2, 32, 4
LOOP = dict(steps=STEPS, seq_len=T, global_batch=B, lr=2e-2,
            warmup_steps=1, log_every=100, device="cpu")


@functools.lru_cache(maxsize=None)
def jx():
    import jax
    import jax.numpy as jnp

    from repro import configs, models, optim

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 models=models, optim=optim)


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """The hand-composed JAX step over the loop's batches: the initial
    parameters (numpy) and per-step loss and grad_norm."""
    j = jx()
    jcfg = j.configs.reduced_config(j.configs.get_config(arch))
    params, _ = j.models.init_model(jcfg, j.jax.random.PRNGKey(0))
    opt_cfg = j.optim.AdamWConfig(lr=LOOP["lr"])

    @j.jax.jit
    def step(params, opt, batch):
        (loss, met), grads = j.jax.value_and_grad(
            lambda p: j.models.train_loss(p, jcfg, batch), has_aux=True)(
            params)
        scale = j.optim.warmup_cosine(opt.step,
                                      warmup_steps=LOOP["warmup_steps"],
                                      total_steps=STEPS)
        params, opt, om = j.optim.adamw_update(opt_cfg, params, grads, opt,
                                               scale)
        return params, opt, dict(met, loss=loss, **om)

    init = j.jax.tree_util.tree_map(np.asarray, params)
    pipe = _pipeline(jcfg.vocab_size)
    opt = j.optim.init_adamw(params)
    out = []
    for s in range(STEPS):
        batch = {k: j.jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        params, opt, met = step(params, opt, batch)
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return init, out


def _pipeline(vocab):
    return SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=vocab, seq_len=T, global_batch=B, seed=0))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b"])
def test_train_step_and_loop_match_the_jax_step(arch):
    init, want = _jax_run(arch)
    loop_cfg = ttrain.TrainLoopConfig(arch=arch, mesh_shape=(1, 1), **LOOP)
    cfg = ttrain.loop_model_config(loop_cfg)
    state = init_train_state(convert.lm_params(init, cfg, device="cpu"))
    step = make_train_step(cfg, opt_cfg=AdamWConfig(lr=LOOP["lr"]),
                           total_steps=STEPS,
                           warmup_steps=LOOP["warmup_steps"])
    pipe = _pipeline(cfg.vocab_size)
    got = []
    for s in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
        state, met = step(state, batch)
        assert set(met) == {"loss", "ce", "aux", "grad_norm", "clip_scale"}
        got.append((float(met["loss"]), float(met["grad_norm"])))
    np.testing.assert_allclose(got, want, **TOL)
    assert int(state.opt.step) == STEPS
    out = ttrain.train(loop_cfg, emit=lambda m: None,
                       model=convert.lm_params(init, cfg, device="cpu"))
    assert out["last_step"] == STEPS and out["straggler_reports"] >= 0
    np.testing.assert_allclose(out["losses"], [w[0] for w in want], **TOL)
    assert out["final_loss"] == out["losses"][-1] < out["losses"][0]


def test_resume_from_checkpoint_equals_uninterrupted(tmp_path):
    kw = dict(LOOP, warmup_steps=20)   # the scale then ignores `steps`
    base = ttrain.train(ttrain.TrainLoopConfig(
        arch="qwen2-1.5b", **dict(kw, steps=10)), emit=lambda m: None)
    log = []
    first = ttrain.train(ttrain.TrainLoopConfig(
        arch="qwen2-1.5b", ckpt_dir=str(tmp_path), ckpt_every=3,
        **dict(kw, steps=6)), emit=log.append)
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 6]
    second = ttrain.train(ttrain.TrainLoopConfig(
        arch="qwen2-1.5b", ckpt_dir=str(tmp_path), ckpt_every=3,
        **dict(kw, steps=10)), emit=log.append)
    assert "[train] resumed from step 6" in log
    assert second["last_step"] == 10 and len(second["losses"]) == 4
    np.testing.assert_allclose(first["losses"], base["losses"][:6],
                               rtol=1e-6)
    np.testing.assert_allclose(second["losses"], base["losses"][6:],
                               rtol=1e-6)
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 9, 10]


def test_sigterm_checkpoints_and_resumes(tmp_path):
    kw = dict(LOOP, steps=6, log_every=1)
    base = ttrain.train(ttrain.TrainLoopConfig(arch="qwen2-1.5b", **kw),
                        emit=lambda m: None)
    before = signal.getsignal(signal.SIGTERM)
    log = []

    def emit(msg):
        log.append(msg)
        if msg.startswith("[train] step 2 "):
            os.kill(os.getpid(), signal.SIGTERM)

    cfg = ttrain.TrainLoopConfig(arch="qwen2-1.5b", ckpt_dir=str(tmp_path),
                                 ckpt_every=100, **kw)
    out = ttrain.train(cfg, emit=emit)
    assert "[train] preemption at step 2; checkpointing" in log
    assert out["last_step"] == 3
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == before
    log.clear()
    resumed = ttrain.train(cfg, emit=log.append)
    assert "[train] resumed from step 3" in log
    assert resumed["last_step"] == 6
    np.testing.assert_allclose(out["losses"] + resumed["losses"],
                               base["losses"], rtol=1e-6)


def test_mesh_other_than_one_device_raises(capfd):
    # A mesh trains on every rank of a process group of its size: without
    # one (a group of one), a 4 x 1 mesh raises; the CLI's --mesh starts
    # its own four gloo ranks on the CPU and trains, rank 0 alone logging.
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ttrain.train(ttrain.TrainLoopConfig(arch="qwen2-1.5b",
                                            mesh_shape=(4, 1), **LOOP))
    ttrain.main(["--arch", "qwen2-1.5b", "--steps", "3", "--seq-len", "32",
                 "--global-batch", "4", "--lr", "2e-2", "--mesh", "2x2",
                 "--device", "cpu"])
    out = capfd.readouterr().out
    assert "[mesh] 4 ranks on the CPU, backend gloo" in out, out
    assert out.count("[train] step 0 loss") == 1, out
    assert "[train] done: 3 steps" in out, out


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_train_runs_on_the_card_unless_told():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(ttrain.TrainLoopConfig(arch="qwen2-1.5b", steps=1))


def _run(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300,
                          check=True).stdout


def test_cli_and_example_train_on_cpu(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch", "qwen2-1.5b",
                "--steps", "4", "--seq-len", "32", "--global-batch", "2",
                "--lr", "2e-2", "--mesh", "1x1", "--device", "cpu"])
    first = float(out.split("[train] step 0 loss ")[1].split()[0])
    last = float(out.split("final loss ")[1].split()[0])
    assert "[train] done: 4 steps" in out and last < first, out
    out = _run([os.path.join("examples", "train_lm_torch.py"), "--steps",
                "6", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "over 6 steps" in out, out
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
