"""Transformer block assembly for the dense family, and the loop over the
stacked layer axis.

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
