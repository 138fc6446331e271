"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 128-expert
top-2 MoE with a dense residual path. bf16 Adam moments (Gopher-style) keep
the optimizer state within v5e HBM at 256-chip scale."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, mlp_act="swiglu",
    moe=True, num_experts=128, experts_per_token=2, num_shared_experts=0,
    moe_d_ff=4864, dense_residual=True,
    param_dtype="bfloat16", moment_dtype="bfloat16",
    optimizer="adafactor", microbatches=16, fsdp_over_pod=True,
)
