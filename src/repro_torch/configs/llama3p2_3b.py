"""llama3.2-3b [dense] — small Llama-3 (hf:meta-llama/Llama-3.2-3B).
28L, d_model 3072, 24H (GQA kv=8), d_ff 8192, vocab 128256."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,              # padded to 32 for TP-16 (DESIGN.md §6)
    num_kv_heads=8,            # < 16 -> replicated KV projections
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=5e5,
))
