"""Sequence-model substrate (PyTorch): layers, attention, the selective
SSM, the MoE layer, the xLSTM blocks and the causal LM assembly, for the
dense, hybrid, MoE and xLSTM families. The encoder-decoder family and
training (``encode``, ``train_loss``) are later sub-slices (ROADMAP
queue A, item 5)."""
from repro_torch.models.transformer import (decode_step, init_caches,
                                            init_model, prefill)

__all__ = ["init_model", "prefill", "decode_step", "init_caches"]
