"""The single-device train step: the body of the JAX package's
``repro.launch.steps.make_train_step`` — ``value_and_grad`` of
`models.train_loss`, the warmup-cosine LR scale at the optimizer's step,
then `optim.adamw_update` — in eager PyTorch on the model's device. Its
sharding tables (and the prefill/decode cell plans of the dry-run) need
a mesh and wait for ROADMAP A, item 4b.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import train_loss
from repro_torch.models.transformer import CausalLM
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_update,
                               init_adamw, warmup_cosine)


class TrainState(NamedTuple):
    params: CausalLM     # the model; AdamW updates its parameters in place
    opt: AdamWState


def init_train_state(model: CausalLM) -> TrainState:
    """The model with zero float32 moments at step 0."""
    return TrainState(params=model, opt=init_adamw(model))


def loss_and_grads(model: CausalLM, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, dict, Dict[str, torch.Tensor]]:
    """``value_and_grad(train_loss)``: (loss, ``{"ce", "aux"}``, the
    gradient of every named parameter). A parameter the loss does not
    reach (a cross-attention's QKV bias, which the reference's
    cross-attention ignores too) gets zeros, as under JAX."""
    params = dict(model.named_parameters())
    loss, metrics = train_loss(model, cfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        n: torch.zeros_like(p) if g is None else g
        for (n, p), g in zip(params.items(), grads)}


def make_train_step(cfg: ModelConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    total_steps: int = 100_000, warmup_steps: int = 2000
                    ) -> Callable[[TrainState, dict],
                                  Tuple[TrainState, dict]]:
    """``step(state, batch) -> (state, metrics)``: one AdamW step on the
    batch (tensors on the model's device: ``tokens``, ``labels`` and an
    encoder-decoder's ``enc_emb``). ``metrics``: ``loss``, ``ce``,
    ``aux``, ``grad_norm`` and ``clip_scale``, device scalars."""

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        model = state.params
        loss, metrics, grads = loss_and_grads(model, cfg, batch)
        lr_scale = warmup_cosine(state.opt.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        _, opt, opt_metrics = adamw_update(
            opt_cfg, dict(model.named_parameters()), grads, state.opt,
            lr_scale)
        return TrainState(params=model, opt=opt), dict(
            metrics, loss=loss, **opt_metrics)

    return step
