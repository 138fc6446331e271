"""Architecture registry: one module per assigned architecture.

The port's own copy of the reference's registry (`repro/configs/`): every
architecture, each of which `models.model.Model` runs."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shape_applicable)

from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from repro_torch.configs.minitron_8b import CONFIG as MINITRON_8B
from repro_torch.configs.yi_34b import CONFIG as YI_34B
from repro_torch.configs.qwen15_05b import CONFIG as QWEN15_05B
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T
from repro_torch.configs.zamba2_12b import CONFIG as ZAMBA2_12B
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as DEEPSEEK_V2_LITE
from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.llava_next_mistral_7b import CONFIG as LLAVA_NEXT

ARCHS = {c.name: c for c in [
    NEMOTRON_4_15B, MINITRON_8B, YI_34B, QWEN15_05B, SEAMLESS_M4T,
    ZAMBA2_12B, DEEPSEEK_V2_LITE, ARCTIC_480B, MAMBA2_780M, LLAVA_NEXT,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    import dataclasses
    kw = dict(
        num_layers=2, d_model=64, d_ff=128 if cfg.d_ff else 0,
        vocab_size=512, moe_group=64,
    )
    if cfg.num_heads:
        kw.update(num_heads=4, head_dim=16,
                  num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0)
    if cfg.moe:
        kw.update(num_experts=4, experts_per_token=2, moe_d_ff=64,
                  first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.use_mla:
        kw.update(kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
                  v_head_dim=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2)
    if cfg.attn_every:
        kw.update(attn_every=2)
    return dataclasses.replace(cfg, **kw)
