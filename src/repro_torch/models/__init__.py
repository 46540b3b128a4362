"""Sequence-model substrate (PyTorch): layers, attention (with
cross-attention), the selective SSM, the MoE layer, the xLSTM blocks and
the LM assembly, for all five families: dense, hybrid, MoE, xLSTM and
encoder-decoder, and the training loss (``train_loss``) on the plain
versions under autograd."""
from repro_torch.models.transformer import (cache_specs, decode_step, encode,
                                            init_caches, init_model, prefill,
                                            train_loss)

__all__ = ["init_model", "encode", "train_loss", "prefill", "decode_step",
           "init_caches", "cache_specs"]
