"""SeamlessM4T-large v2 [arXiv:2308.11596]: enc-dec; audio frontend stubbed
as precomputed frame embeddings via input_specs()."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=8192, vocab_size=256206, mlp_act="swiglu",
    embeds_input=True,
)
