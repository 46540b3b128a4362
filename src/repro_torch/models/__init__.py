"""Sequence-model substrate (PyTorch): layers, attention (with
cross-attention), the selective SSM, the MoE layer, the xLSTM blocks and
the LM assembly, for all five families: dense, hybrid, MoE, xLSTM and
encoder-decoder. Training (``train_loss``) is a later sub-slice (ROADMAP
queue A, item 5f)."""
from repro_torch.models.transformer import (decode_step, encode,
                                            init_caches, init_model, prefill)

__all__ = ["init_model", "encode", "prefill", "decode_step", "init_caches"]
