"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517). 24 blocks
at 7:1 mLSTM:sLSTM (sLSTM at blocks 7, 15, 23), d_model 1024, 4 heads,
vocab 50304, d_ff=0 (block-internal projections only). mLSTM runs the
paper's parallel-scan primitive chunkwise; sLSTM is sequential (memory
mixing — documented non-parallelizable). Fully recurrent state -> O(1)
decode, runs long_500k."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    slstm_layers=(7, 15, 23),
    mlstm_proj_factor=2.0,
    uses_parallel_scan=True,
    subquadratic=True,
))
