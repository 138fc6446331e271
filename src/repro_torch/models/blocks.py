"""Block assembly for every family (dense, MoE with MLA or GQA, SSM), and
the loop over the stacked layer axis.

The reference runs its stacked layers with `lax.scan` (and remat) and
pins activation shardings at block boundaries (`boundary`, `gathered`).
On one device those constraints are the identity, and serving keeps no
activations for a backward, so here a block is plain code and
`scan_stack` is a Python loop over the leading axis of each stacked
tensor (views, no per-layer copies).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as S
from repro_torch.models import mla as M
from repro_torch.models import moe as E
from repro_torch.models.pspec import tree_map


def layer(params_stacked, i: int):
    """Layer i's parameters: a view of each stacked tensor."""
    return tree_map(lambda t: t[i], params_stacked)


def num_layers(params_stacked) -> int:
    t = params_stacked
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t.shape[0]


def dense_block_specs(cfg: ModelConfig):
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=A.attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        mlp=L.mlp_specs(cfg),
    )


def dense_block(p, x, cfg: ModelConfig):
    """One pre-norm block; returns the output and the layer's (K, V)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, kv = A.attend_train(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg)
    return x, kv


def _attn_specs(cfg: ModelConfig):
    return M.mla_specs(cfg) if cfg.use_mla else A.attn_specs(cfg)


def _attend(p, h, cfg: ModelConfig):
    """MLA or GQA self-attention of an MoE-family layer: its output and
    its decode cache (the MLA latent (c_kv, k_rope), or (K, V))."""
    fn = M.mla_train if cfg.use_mla else A.attend_train
    return fn(p, h, cfg)


def moe_block_specs(cfg: ModelConfig):
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=_attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        moe=E.moe_specs(cfg),
    )


def moe_block(p, x, cfg: ModelConfig):
    """Returns the output and (the layer's MoE `aux`, its decode cache)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = _attend(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    y, aux = E.moe_apply(p["moe"], h, cfg)
    return x + y, (aux, cache)


def dense_ffn_block_specs(cfg: ModelConfig):
    """DeepSeek's first-k-dense layer: MLA (or GQA) attention + SwiGLU."""
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=_attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        mlp=L.mlp_specs(cfg),
    )


def dense_ffn_block(p, x, cfg: ModelConfig):
    """Returns the output and (None, the layer's decode cache)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = _attend(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg), (None, cache)


def ssm_block_specs(cfg: ModelConfig):
    return dict(
        ln=L.rmsnorm_spec(cfg.d_model),
        mixer=S.mamba_specs(cfg),
    )


def ssm_block(p, x, cfg: ModelConfig, with_state: bool = False):
    """One pre-norm Mamba2 block; with `with_state`, its second result is
    the layer's (final SSD state, conv tail) for a decode cache."""
    h = L.rmsnorm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    if with_state:
        y, st, conv_tail = S.mamba_train(p["mixer"], h, cfg, with_state=True)
        return x + y, (st, conv_tail)
    return x + S.mamba_train(p["mixer"], h, cfg), None


def scan_stack(block_fn, params_stacked, x, cfg: ModelConfig):
    """Run `block_fn` over the stacked layers in order; returns the output
    and the list of each layer's second result."""
    outs = []
    for i in range(num_layers(params_stacked)):
        x, out = block_fn(layer(params_stacked, i), x, cfg)
        outs.append(out)
    return x, outs


def dense_decode_block(p, x, cache, cfg: ModelConfig):
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = A.attend_decode(p["attn"], h, cache, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg)
    return x, cache


def moe_decode_block(p, x, cache, cfg: ModelConfig):
    """An MoE-family layer's decode: MLA or GQA attention against its
    cache, then the experts (or the dense MLP of a first-k-dense layer)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    if cfg.use_mla:
        y, cache = M.mla_decode(p["attn"], h, cache, cfg)
    else:
        y, cache = A.attend_decode(p["attn"], h, cache, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    if "moe" in p:
        y, _ = E.moe_apply(p["moe"], h, cfg)
    else:
        y = L.mlp_apply(p["mlp"], h, cfg)
    return x + y, cache


def ssm_decode_block(p, x, cache, cfg: ModelConfig):
    h = L.rmsnorm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    y, cache = S.mamba_decode(p["mixer"], h, cache, cfg)
    return x + y, cache
