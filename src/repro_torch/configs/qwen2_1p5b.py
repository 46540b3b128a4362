"""qwen2-1.5b [dense] — extreme GQA + QKV bias (arXiv:2407.10671).
28L, d_model 1536, 12H (GQA kv=2), d_ff 8960, vocab 151936."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,              # padded to 16 for TP-16 (DESIGN.md §6)
    num_kv_heads=2,            # < 16 -> replicated KV projections
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,       # qwen2-1.5b ties input/output embeddings
))
