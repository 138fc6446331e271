"""Shared layers: norms, rotary embeddings, MLPs, embedding tables.

Each function rounds where the reference's does: weights are cast to the
activations' dtype at use (a no-op for weights the model already holds in
that dtype), `rmsnorm` takes its variance in float32 and casts the rsqrt
back before two products in the activations' dtype, and `apply_rope`
rotates in float32 and casts back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.pspec import PSpec


def rmsnorm(x, w, eps=1e-5):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rmsnorm_spec(d):
    return PSpec((d,), (None,), "ones")


# --- rotary ---------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs         # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --- MLP ------------------------------------------------------------------

def sigmoid(x):
    """1 / (1 + exp(-x)), rounded to x's dtype at each step: XLA's
    expansion of the reference's `lax.logistic` (`jax.nn.silu`), which
    `torch.sigmoid`'s single rounding misses by a bf16 ulp in a few
    percent of elements."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """x · sigmoid(x), `jax.nn.silu`'s two roundings."""
    return x * sigmoid(x)


def mlp_specs(cfg: ModelConfig, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return dict(
            wi=PSpec((d, 2 * f), ("fsdp", "model")),
            wo=PSpec((f, d), ("model", "fsdp")),
        )
    # relu2 (nemotron squared-ReLU): single up projection
    return dict(
        wi=PSpec((d, f), ("fsdp", "model")),
        wo=PSpec((f, d), ("model", "fsdp")),
    )


def mlp_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D)."""
    h = x @ p["wi"].to(x.dtype)
    if cfg.mlp_act == "swiglu":
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * silu(g)
    else:
        r = F.relu(h)
        h = r * r
    return h @ p["wo"].to(x.dtype)


# --- embeddings -----------------------------------------------------------

def embed_specs(cfg: ModelConfig):
    tok_logical = ("model", "fsdp") if cfg.tie_embeddings else (None, "fsdp")
    out = dict(tok=PSpec((cfg.padded_vocab, cfg.d_model), tok_logical,
                         "small"))
    if not cfg.tie_embeddings:
        out["out"] = PSpec((cfg.d_model, cfg.padded_vocab),
                           ("fsdp", "model"), "small")
    return out


def embed_tokens(p, tokens):
    """tokens (B, S) -> (B, S, D), in the table's dtype."""
    return p["tok"][tokens]


def unembed(p, x, cfg: ModelConfig):
    """(B, S, D) -> (B, S, padded_vocab) logits: the padded ids' logits
    are computed too, as in the reference."""
    if cfg.tie_embeddings:
        return x @ p["tok"].to(x.dtype).T
    return x @ p["out"].to(x.dtype)


def softmax_xent(logits, labels, vocab_size: int):
    """Mean next-token cross entropy; labels == -1 are masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
