"""Mamba2-780M [arXiv:2405.21060]: attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
