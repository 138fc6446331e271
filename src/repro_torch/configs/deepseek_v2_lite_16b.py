"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA (kv_lora 512) + MoE
(2 shared + 64 routed, top-6), first layer dense."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, mlp_act="swiglu",
    moe=True, num_experts=64, experts_per_token=6, num_shared_experts=2,
    moe_d_ff=1408, first_k_dense=1,
    use_mla=True, kv_lora_rank=512, qk_rope_head_dim=64,
    qk_nope_head_dim=128, v_head_dim=128,
    microbatches=4,
)
