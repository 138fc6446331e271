"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
anyres patch frontend stubbed as precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, mlp_act="swiglu",
    embeds_input=True,
    microbatches=2,
)
