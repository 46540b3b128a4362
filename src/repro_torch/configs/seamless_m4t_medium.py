"""seamless-m4t-medium [audio] — encoder-decoder backbone
(arXiv:2308.11596). 12L enc + 12L dec, d_model 1024, 16H (kv=16),
d_ff 4096, vocab 256206. The audio frontend (w2v-BERT conformer feature
extractor) is a STUB per the task spec: `input_specs()` provides
precomputed frame embeddings [B, S_enc, d]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    encoder_seq_len=1024,      # stub frontend output length
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    rope_theta=1e4,
))
