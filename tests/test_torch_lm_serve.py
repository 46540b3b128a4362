"""Port parity: the LM decode service. The port's serve loop
(`launch.serve.generate`) on JAX's parameters and prompts gives the same
greedy tokens as a JAX loop over ``repro.models.decode_step`` (the loop of
``repro.launch.serve.serve``), and the port's CLI ``--workload decode``
runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.launch import serve as jserve
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_model as jinit_model
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as tserve
from _torch_jax import release_jax_caches  # noqa: F401


def _jax_greedy(params, cfg, prompts, gen, max_len):
    """``repro.launch.serve.serve``'s loop on given params and prompts."""
    caches = jinit_caches(cfg, prompts.shape[0], max_len)
    step = jax.jit(lambda c, t, p: jdecode_step(params, cfg, c, t, p))
    for i in range(prompts.shape[1]):
        logits, caches = step(caches, prompts[:, i:i + 1],
                              jnp.asarray(i, jnp.int32))
    tok = jnp.argmax(logits[:, :, :cfg.vocab_size], axis=-1).astype(
        jnp.int32)
    out = []
    for j in range(gen):
        out.append(tok)
        logits, caches = step(caches, tok,
                              jnp.asarray(prompts.shape[1] + j, jnp.int32))
        tok = jnp.argmax(logits[:, :, :cfg.vocab_size], axis=-1).astype(
            jnp.int32)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,prompt_len,gen,max_len", [
    ("qwen2-1.5b", 8, 8, 32),
    ("llama3.2-3b", 6, 6, 10)])   # the cache fills: the last row rewritten
def test_greedy_tokens_equal_jax(arch, prompt_len, gen, max_len):
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    params, _ = jinit_model(jcfg, jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (3, prompt_len), 0,
                                 jcfg.vocab_size)
    want = _jax_greedy(params, jcfg, prompts, gen, max_len)
    model = convert.lm_params(jax.tree_util.tree_map(np.asarray, params),
                              cfg, device="cpu")
    out = tserve.generate(model, cfg, torch.tensor(np.asarray(prompts)), gen,
                          max_len)
    assert out["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["tok_per_s"] > 0 and out["seconds"] > 0


def test_serve_config_fields_equal_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(
        tserve.ServeConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(
        jserve.ServeConfig)]
    assert ours == theirs


def test_serve_on_cpu():
    lines = []
    out = tserve.serve(tserve.ServeConfig(arch="internlm2-1.8b", batch=2,
                                          prompt_len=4, gen=3),
                       emit=lines.append, device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert lines and lines[0].startswith("[serve] 2 seqs x 7 steps")
    cfg = reduced_config(get_config("internlm2-1.8b"))
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size))
                .all())


def test_decode_cli_on_cpu(capsys):
    tserve.main(["--workload", "decode", "--arch", "qwen2-1.5b", "--batch",
                 "2", "--prompt-len", "4", "--gen", "4", "--device", "cpu"])
    assert "[serve] 2 seqs x 8 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--workload", "decode", "--device", "cpu"])  # no --arch


def test_serve_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(tserve.ServeConfig(arch="qwen2-1.5b"))


@pytest.mark.parametrize("flag", [["--seed", "1"], ["--lm-lambda", "2.0"]])
def test_cli_has_no_flag_the_jax_cli_lacks(flag, capsys):
    """Neither CLI takes ``--seed`` or ``--lm-lambda`` (the configs keep
    the fields): argparse's error, exit code 2, in both."""
    for main in (tserve.main, jserve.main):
        with pytest.raises(SystemExit) as exc:
            main(["--workload", "smoother"] + flag)
        assert exc.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err
