"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, mlp_act="swiglu",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    microbatches=4,
    attn_every=6,
)
