"""Model configuration system: one frozen dataclass drives every
architecture in the zoo; per-arch files instantiate it and register under
an ``--arch <id>`` name.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shape cells (task spec).
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_mode: str = "standard"          # standard | mrope
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0              # 0 = full attention
    global_layers: Tuple[int, ...] = ()  # full-attn layers in hybrid archs
    attn_logit_softcap: float = 0.0

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- xLSTM ---
    slstm_layers: Tuple[int, ...] = ()   # which blocks are sLSTM
    mlstm_proj_factor: float = 2.0

    # --- encoder-decoder / frontends ---
    encoder_layers: int = 0
    encoder_seq_len: int = 1024          # stub frontend output length
    frontend: Optional[str] = None       # 'audio' | 'vision' (stubbed)

    # --- numerics / misc ---
    rmsnorm_eps: float = 1e-5
    tie_embeddings: bool = False
    z_loss: float = 1e-4
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- sharding knobs (DESIGN.md §6) ---
    tp_size: int = 16                    # model-axis size sharding assumes
    fsdp_params: bool = False            # 2-D weight sharding in train
    vocab_pad_multiple: int = 2048       # 16-way x 128-lane alignment
    remat: str = "block"                 # none | block
    attn_chunk: int = 2048               # blockwise-causal chunk (jnp path)
    scan_chunk: int = 256                # SSM/mLSTM chunk length

    # Technique applicability (DESIGN.md §4): archs whose layers run on the
    # paper's parallel-scan engine.
    uses_parallel_scan: bool = False
    # Sub-quadratic full-context support (decides long_500k runnability).
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        """Q heads padded up to a multiple of tp_size when needed (zero
        -weight heads; exact outputs, see DESIGN.md §6)."""
        h, tp = self.num_heads, self.tp_size
        return h if h % tp == 0 else h + (tp - h % tp)

    @property
    def shard_kv_heads(self) -> bool:
        return self.num_kv_heads % self.tp_size == 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_ff_per_expert(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(runnable, reason-if-not) for an assigned shape cell."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False, ("pure full-attention arch: O(T^2) attention has "
                           "no sub-quadratic full-context path (DESIGN.md §4)")
        return True, ""

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline bookkeeping)."""
        d, L = self.d_model, self.num_layers
        dh = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = L * d * dh * (self.num_heads * 2 + self.num_kv_heads * 2)
        if self.num_experts:
            dff = self.d_ff_per_expert
            moe = L * (3 * d * dff * (self.num_experts
                                      + self.num_shared_experts)
                       + d * self.num_experts)
            mlp = moe
        else:
            mlp = L * 3 * d * self.d_ff if self.d_ff else 0
        ssm = 0
        if self.family in ("hybrid",):
            din = self.ssm_expand * d
            ssm = L * (2 * d * din + din * (2 * self.ssm_state + 2)
                       + din * d)
        if self.family == "ssm":   # xLSTM blocks
            pf = self.mlstm_proj_factor
            din = int(pf * d)
            ssm = L * (3 * din * din + 2 * d * din + 3 * din)
            mlp = 0
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (attn // L + mlp // max(L, 1)
                                         + d * d * 0)
        return int(emb + attn + mlp + ssm + enc)

    def active_param_count(self) -> int:
        """Params touched per token (MoE top-k), for 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        dff = self.d_ff_per_expert
        total = self.param_count()
        all_experts = L * 3 * d * dff * self.num_experts
        active = L * 3 * d * dff * self.num_experts_per_tok
        return int(total - all_experts + active)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduced config for CPU smoke tests and examples:
    same block structure (GQA ratio, MoE routing, hybrid/sLSTM patterns,
    enc-dec, M-RoPE), tiny dims."""
    L = 4
    changes = dict(
        num_layers=L,
        d_model=64,
        num_heads=4,
        head_dim=16,
        num_kv_heads=4 if cfg.num_kv_heads == cfg.num_heads else 2,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=64,
        tp_size=1,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=64,
        scan_chunk=32,
        remat=cfg.remat,
    )
    if cfg.num_experts:
        # capacity_factor = E/k makes capacity >= n for any routing, i.e.
        # drop-free: decode logits match prefill exactly in tests.
        changes.update(num_experts=4, num_experts_per_tok=2,
                       moe_d_ff=64, capacity_factor=2.0,
                       num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family == "hybrid":
        changes.update(global_layers=(0, L - 1),
                       sliding_window=32, ssm_state=8)
    if cfg.family == "ssm":
        changes.update(slstm_layers=(L - 1,))
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq_len=32)
    if cfg.rope_mode == "mrope":
        changes.update(mrope_sections=(4, 2, 2))  # head_dim 16 -> half 8
    changes.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **changes)


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown arch {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from e


def list_configs():
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    # Import arch modules for registration side effects.
    from repro_torch.configs import (  # noqa: F401
        hymba_1p5b, seamless_m4t_medium, internlm2_1p8b, codeqwen1p5_7b,
        llama3p2_3b, qwen2_1p5b, xlstm_350m, qwen2_vl_72b, grok_1_314b,
        deepseek_moe_16b)
