"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).
80L decoder backbone, d_model 8192, 64H (GQA kv=8), d_ff 29568,
vocab 152064. The vision frontend (ViT) is a STUB per the task spec:
patch embeddings arrive precomputed; M-RoPE sections (16, 24, 24) over
head_dim 128 (temporal/height/width)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,            # < 16 -> replicated KV projections
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    frontend="vision",
    fsdp_params=True,          # 72B: 1-D TP params+grads exceed HBM
))
