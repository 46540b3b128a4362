"""grok-1-314b [moe] — 8 experts top-2 (hf:xai-org/grok-1). 64L,
d_model 6144, 48H (GQA kv=8), per-expert d_ff 32768, vocab 131072,
attention logit soft-capping 30. Experts < TP-16 -> expert-internal TP
(d_ff sharded) + 2-D FSDP weight sharding (DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,            # < 16 -> replicated KV projections
    head_dim=128,
    d_ff=32768,
    moe_d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    num_experts_per_tok=2,
    attn_logit_softcap=30.0,
    rope_theta=1e4,
))
