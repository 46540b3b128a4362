"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per block
(arXiv:2411.13676). 32L, d_model 1600, 25H (GQA kv=5), d_ff 5504,
vocab 32001, ssm_state 16. Sliding-window attention with 3 global-attention
layers (first/middle/last, per the paper); meta-token prefix omitted
(frontend-level detail, DESIGN.md §4). Uses the paper's parallel-scan
engine inside every block (Mamba heads) -> runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,          # padded to 32 for TP-16 (DESIGN.md §6)
    num_kv_heads=5,        # < 16 -> replicated KV projections
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    global_layers=(0, 16, 31),
    rope_theta=1e4,
    uses_parallel_scan=True,
    subquadratic=True,
))
