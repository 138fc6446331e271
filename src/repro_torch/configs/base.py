"""Config system: model architecture, input shapes, mesh, run settings."""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers every assigned architecture family."""
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    # --- attention options ---
    qkv_bias: bool = False                  # qwen1.5
    rope_theta: float = 10000.0
    attn_chunk: int = 256                   # flash-style KV chunk in train/prefill
    # --- MLP ---
    mlp_act: str = "swiglu"                 # swiglu | relu2 (nemotron squared-ReLU)
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0             # deepseek shared experts
    moe_d_ff: int = 0                       # per-expert hidden
    dense_residual: bool = False            # arctic: dense FFN in parallel
    first_k_dense: int = 0                  # deepseek: first k layers dense
    moe_group: int = 256                    # dispatch group size (tokens);
    #                                         dispatch memory ~ tokens*E*g*k/E
    #                                         scales linearly with g
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256                    # SSD chunk length
    attn_every: int = 0                     # hybrid: shared attn block period
    # --- enc-dec (seamless) ---
    encoder_layers: int = 0                 # decoder layers = num_layers
    # --- embeddings / frontends ---
    tie_embeddings: bool = False
    embeds_input: bool = False              # audio/vlm: frontend stub provides
    #                                         (B, S, d_model) embeddings
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- optimizer memory knobs (distributed-optimization tricks) ---
    param_dtype: str = "float32"            # master weights
    moment_dtype: str = "float32"           # bf16 for the very largest models
    optimizer: str = "adamw"                # adamw | adafactor
    kv_quant: bool = False                  # int8 decode KV cache (+scales)
    fsdp_over_pod: bool = False             # ZeRO-3 spanning the pod axis
    microbatches: int = 1                   # gradient-accumulation splits for
    #                                         train_4k (activation memory / N)

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        if self.num_heads == 0:
            return self.head_dim or 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        """Query heads padded so TP=16 divides them (yi/arctic: 56 -> 64).
        As in the reference, the padded heads are drawn at init like every
        other head (`models.pspec.init_params`), so they are live: they add
        to the attention output, and GQA's group size is
        `padded_heads // num_kv_heads`."""
        return _round_up(self.num_heads, 16)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline cross-check)."""
        d, v = self.d_model, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        n = emb
        layers = self.num_layers
        hd = self.head_dim_
        if self.family in ("dense", "vlm", "audio"):
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
            ff = (3 if self.mlp_act == "swiglu" else 2) * d * self.d_ff
            n += layers * (attn + ff + 2 * d)
        elif self.family == "encdec":
            attn = 2 * d * self.num_heads * hd + 2 * 2 * d * self.num_kv_heads * hd
            ff = 3 * d * self.d_ff
            n += self.encoder_layers * (attn + ff + 2 * d)
            n += layers * (2 * attn + ff + 3 * d)    # self+cross attn
        elif self.family == "moe":
            if self.use_mla:
                attn = (d * self.kv_lora_rank + d * self.qk_rope_head_dim
                        + self.kv_lora_rank * self.num_heads
                        * (self.qk_nope_head_dim + self.v_head_dim)
                        + d * self.num_heads
                        * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                        + self.num_heads * self.v_head_dim * d)
            else:
                attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                    + self.num_heads * hd * d
            expert = 3 * d * self.moe_d_ff
            moe = (self.num_experts + self.num_shared_experts) * expert \
                + d * self.num_experts
            if self.dense_residual:
                moe += 3 * d * self.d_ff
            dense_ff = 3 * d * (self.d_ff if self.first_k_dense else 0)
            n += self.first_k_dense * (attn + dense_ff + 2 * d)
            n += (layers - self.first_k_dense) * (attn + moe + 2 * d)
        elif self.family == "ssm":
            mix = d * 2 * self.d_inner + d * (2 * self.ssm_state
                                              + self.ssm_heads) \
                + 4 * self.d_inner + self.d_inner * d + 3 * self.ssm_heads
            n += layers * (mix + d)
        elif self.family == "hybrid":
            mix = d * 2 * self.d_inner + d * (2 * self.ssm_state
                                              + self.ssm_heads) \
                + 4 * self.d_inner + self.d_inner * d + 3 * self.ssm_heads
            n += layers * (mix + d)
            attn = 4 * d * self.num_heads * hd + 3 * d * self.d_ff + 2 * d
            n += attn                                 # one shared block
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        full = self.param_count()
        expert = 3 * self.d_model * self.moe_d_ff
        inactive = (self.num_experts - self.experts_per_token) * expert \
            * (self.num_layers - self.first_k_dense)
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: only SSM/hybrid run it.
LONG_OK_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_OK_FAMILIES
    return True
