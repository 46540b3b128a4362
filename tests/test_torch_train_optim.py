"""Port parity: the training substrates — AdamW, its weight-decay mask and
LR schedules, the token pipeline and the checkpoint manager.

`optim.adamw_update` is held against the JAX package's ``adamw_update``
on the same numpy parameters and gradients over several steps, with and
without clipping, on float32 and on bfloat16 parameters (float32 moments
both), at the suite's float32 tolerance. The decay mask is compared leaf
for leaf with the reference's ``_decay_mask`` on the JAX parameters of
all five families' reduced configs, carried into the port's layout by
``convert.lm_tree``: the reference decays the QKV biases (its path
``runs//attn/bq`` holds none of its tokens) and the sLSTM's ``b``, and so
does the port. ``warmup_cosine`` and ``constant`` are held against JAX's;
`SyntheticTokenPipeline` batches are byte-equal to JAX's; the checkpoint
manager passes the port's counterparts of the reference's single-device
checkpoint tests, a bit-exact bfloat16 round trip, and a restore of a
model and its AdamW state.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import tokens as jtokens
from repro.models import init_model as jinit_model
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import tokens as ttokens
from repro_torch.distributed import NamedSharding, P
from repro_torch.launch.steps import init_train_state
from repro_torch.models import init_model
from repro_torch.optim import (AdamWConfig, adamw_update, constant,
                               decay_mask, global_norm, init_adamw,
                               warmup_cosine)
from _torch_jax import release_jax_caches  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
FAMILIES = ["qwen2-1.5b", "hymba-1.5b", "deepseek-moe-16b", "xlstm-350m",
            "seamless-m4t-medium"]

# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

#: A parameter tree with leaves the mask decays and leaves it skips.
SHAPES = {"w": (4, 8), "layer": {"norm_w": (8,), "proj": (8, 3),
                                 "b_gate": (3,)},
          "bias": (8,), "dt_bias": (5,), "A_log": (5, 2)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *head, last = name.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _draw(rng, scale=1.0):
    return {n: (scale * rng.standard_normal(s)).astype(np.float32)
            for n, s in _flat(SHAPES).items()}


@pytest.mark.parametrize("clip_norm", [1.0, 100.0], ids=["clipped", "free"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip_norm, dtype):
    rng = np.random.default_rng(0)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm)
    p0 = _draw(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _nest(p0))
    tp = {n: torch.tensor(a).to(tdt) for n, a in p0.items()}
    js = jadamw.init_adamw(jp)
    ts = init_adamw(tp)
    for step, lr_scale in enumerate((1.0, 0.5, 0.25)):
        g = _draw(rng, scale=3.0)
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _nest(g))
        tg = {n: torch.tensor(a).to(tdt) for n, a in g.items()}
        jp, js, jm = jadamw.adamw_update(jcfg, jp, jg, js,
                                         jnp.float32(lr_scale))
        tp, ts, tm = adamw_update(cfg, tp, tg, ts, lr_scale)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        if clip_norm == 1.0:
            assert float(tm["clip_scale"]) < 1.0
        jflat = {k: _flat(v) for k, v in (("p", jp), ("m", js.m),
                                          ("v", js.v))}
        for n in p0:
            assert tp[n].dtype == tdt
            assert ts.m[n].dtype == ts.v[n].dtype == torch.float32
            np.testing.assert_allclose(ts.m[n].numpy(), jflat["m"][n], **TOL)
            np.testing.assert_allclose(ts.v[n].numpy(), jflat["v"][n], **TOL)
            got = tp[n].float().numpy()
            want = np.asarray(jflat["p"][n], np.float32)
            if dtype == "bfloat16":
                # Both round the same float32 update to bfloat16; a value
                # within float32 rounding of a bfloat16 tie may round
                # either way: one bfloat16 ulp (2^-8 relative).
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
            else:
                np.testing.assert_allclose(got, want, **TOL)


def test_weight_decay_mask_skips_norms_and_biases():
    """The reference's own mask test, on the port: decayed ``w`` shrinks
    under zero gradients; ``norm_w`` and ``bias`` do not move."""
    params = {"layer.w": torch.ones((4, 8)), "layer.norm_w": torch.ones(8),
              "bias": torch.zeros(8)}
    before = {n: p.clone() for n, p in params.items()}
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, clip_norm=1e9)
    zero = {n: torch.zeros_like(p) for n, p in params.items()}
    adamw_update(cfg, params, zero, init_adamw(params))
    assert float(params["layer.w"].abs().max()) < 1.0
    for n in ("layer.norm_w", "bias"):
        assert torch.equal(params[n], before[n])


def test_global_norm_and_quadratic_descent():
    t = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    assert float(global_norm(t.values())) == pytest.approx(5.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_adamw(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=100.0)
    losses = []
    for _ in range(50):
        params, state, _ = adamw_update(cfg, params,
                                        {"w": 2 * params["w"]}, state)
        losses.append(float((params["w"] ** 2).sum()))
    assert losses[-1] < 1e-2 * losses[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_decay_mask_matches_jax_leaf_for_leaf(arch):
    cfg = reduced_config(get_config(arch))
    jparams, _ = jinit_model(jreduced_config(jget_config(arch)),
                             jax.random.PRNGKey(0))
    jmask = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, jadamw._decay_mask(path)), jparams)
    names = [n for n, _ in init_model(cfg, 0, device="cpu")
             .named_parameters()]
    want = convert.lm_tree(jmask, names)
    got = decay_mask(names)
    assert set(got) == set(names)
    for n in names:
        assert want[n].all() or not want[n].any(), n   # one verdict a leaf
        assert got[n] == bool(want[n].all()), (n, convert.jax_path(n))
    if cfg.qkv_bias:
        assert got["runs.0.0.attn.wq.bias"]   # the reference decays bq
    if cfg.slstm_layers:
        assert any(got[n] for n in names if n.endswith("slstm.b"))
    assert not any(got[n] for n in names if "norm" in n or "ln" in n)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 10)])
def test_warmup_cosine_matches_jax(warmup, total):
    for step in (0, 1, 5, 10, 11, 37, 50, 99, 100, 150):
        want = float(jschedule.warmup_cosine(step, warmup_steps=warmup,
                                             total_steps=total))
        got = warmup_cosine(step, warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)
        on_tensor = warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                  warmup_steps=warmup, total_steps=total)
        assert float(on_tensor) == float(got)


def test_constant_matches_jax():
    assert float(constant(7)) == float(jschedule.constant(7)) == 1.0
    assert float(constant(torch.tensor(3), 0.5)) == \
        float(jschedule.constant(3, 0.5))


# ---------------------------------------------------------------------------
# Token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_token_batches_byte_equal_to_jax(seed, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=512, seq_len=16, global_batch=8, seed=seed,
                  num_hosts=hosts, host_id=host)
        tp = ttokens.SyntheticTokenPipeline(ttokens.TokenPipelineConfig(**kw))
        jp = jtokens.SyntheticTokenPipeline(jtokens.TokenPipelineConfig(**kw))
        for step in (0, 1, 13):
            got, want = tp.batch_at(step), jp.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                assert got[k].tobytes() == want[k].tobytes()
        it = tp.iter_from(5)
        assert next(it)["tokens"].tobytes() == \
            jp.batch_at(5)["tokens"].tobytes()
    resharded = tp.reshard(1, 0)
    assert ttokens.global_batch_check([tp, resharded]) == \
        jtokens.global_batch_check([jp, jp.reshard(1, 0)])


def test_token_pipeline_refuses_uneven_hosts():
    with pytest.raises(ValueError):
        ttokens.SyntheticTokenPipeline(ttokens.TokenPipelineConfig(
            vocab_size=16, seq_len=4, global_batch=6, num_hosts=4))


# ---------------------------------------------------------------------------
# Checkpoints (the port's counterparts of tests/substrates/
# test_checkpoint.py, single device)
# ---------------------------------------------------------------------------

def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(1.5)
    mgr.save(7, state)
    restored = mgr.restore(_state())
    np.testing.assert_allclose(restored["params"]["w"],
                               state["params"]["w"])
    assert int(restored["step"]) == 3
    assert mgr.latest_step() == 7


def test_checkpoint_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0), blocking=False)
    mgr.save(2, _state(2.0), blocking=False)  # joins the first
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    r = mgr.restore(_state(), step=2)
    np.testing.assert_allclose(r["params"]["w"], 2.0)


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """The state changes in place right after a non-blocking save (the
    next training step); the checkpoint holds the values at the save."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state(1.0)
    mgr.save(1, state, blocking=False)
    state["params"]["w"].fill_(9.0)
    mgr.wait()
    np.testing.assert_allclose(mgr.restore(_state())["params"]["w"], 1.0)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(float(s)))
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_commit_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _state())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert sorted(os.listdir(mgr.path_for(5))) == [
        "leaf_0.npy", "leaf_1.npy", "leaf_2.npy", "manifest.json"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.ones(4)},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError):
        mgr.restore(bad)
    assert torch.equal(bad["params"]["b"], torch.ones(4))  # nothing written
    with pytest.raises(KeyError):
        mgr.restore({"other": torch.zeros(1)})
    # With shardings, a leaf is the rank's block of the saved array: rank
    # 1 of a two-rank "data" axis (a stand-in mesh: a block needs only the
    # axis sizes and the rank's coordinates) restores the lower half.
    saved = _state()
    saved["params"]["w"] = torch.arange(16.0).reshape(4, 4)
    mgr.save(2, saved)
    mesh = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",),
                                 coords={"data": 1})
    shardings = {"params": {"w": NamedSharding(mesh, P("data", None)),
                            "b": None}, "step": None}
    block = {"params": {"w": torch.zeros((2, 4)), "b": torch.ones(4)},
             "step": torch.tensor(0, dtype=torch.int32)}
    mgr.restore(block, shardings=shardings)
    assert torch.equal(block["params"]["w"], saved["params"]["w"][2:])
    assert torch.equal(block["params"]["b"], torch.zeros(4))
    with pytest.raises(ValueError, match="the block under"):
        mgr.restore(_state(), shardings=shardings)


def test_checkpoint_bfloat16_round_trip_is_bit_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=gen).to(torch.bfloat16)
    w[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    mgr.save(1, {"w": w, "m": torch.randn(3, generator=gen)})
    with open(os.path.join(mgr.path_for(1), "manifest.json")) as f:
        assert '"dtype": "bfloat16"' in f.read()
    out = mgr.restore({"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                       "m": torch.zeros(3)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))


def test_checkpoint_restores_a_train_state_in_place(tmp_path):
    cfg = reduced_config(get_config("qwen2-1.5b"), param_dtype="bfloat16")
    state = init_train_state(init_model(cfg, 0, device="cpu"))
    for m in state.opt.m.values():
        m.normal_()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    other = init_train_state(init_model(cfg, 1, device="cpu"))
    params = dict(other.params.named_parameters())
    out = mgr.restore(other)
    assert out is other
    for n, p in state.params.named_parameters():
        assert params[n] is dict(out.params.named_parameters())[n]
        assert torch.equal(params[n].view(torch.int16),
                           p.view(torch.int16)), n
        assert torch.equal(other.opt.m[n], state.opt.m[n])
    assert int(other.opt.step) == 0
