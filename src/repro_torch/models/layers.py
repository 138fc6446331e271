"""Shared layers: norms, rotary embeddings, MLPs, embedding tables.

Each function rounds where the reference's does: weights are cast to the
activations' dtype at use (a no-op for weights the model already holds in
that dtype), `rmsnorm` takes its variance in float32 and casts the rsqrt
back before two products in the activations' dtype, and `apply_rope`
rotates in float32 and casts back. Where the reference's gradient is a
rule of jax's own (`lax.logistic`), the port's backward is that rule.

Over a mesh (the `*_tp` functions), a data row's tensors are lists with
one entry per position of the "model" axis, each on that position's
device, and the weights are the positions' pieces after the FSDP gather:
the MLP is column- then row-parallel (its output a partial sum per
position), the vocab is split over the positions for the lookup, the
logits and the cross-entropy. Each gives the unsharded function up to the
order of its sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
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

class _Logistic(torch.autograd.Function):
    """`lax.logistic` with jax's gradient, g · (s · (1 - s)): the autograd
    of the written-out formula would multiply a zero cotangent by
    exp(-x) = inf below x ≈ -88 and give NaN, where jax's is finite."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x):
    """1 / (1 + exp(-x)), rounded to x's dtype at each step: XLA's
    expansion of the reference's `lax.logistic` (`jax.nn.silu`), which
    `torch.sigmoid`'s single rounding misses by a bf16 ulp in a few
    percent of elements. Its gradient is jax's (`_Logistic`)."""
    return _Logistic.apply(x)


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


def _take(pieces, lo: int, hi: int, dim: int, device):
    """Elements [lo, hi) along `dim` of a tensor split into equal blocks
    `pieces` along it, read from the pieces that hold them, on `device`."""
    n = pieces[0].shape[dim]
    parts = []
    for i in range(lo // n, -(-hi // n)):
        a, b = max(lo, i * n), min(hi, (i + 1) * n)
        parts.append(pieces[i].narrow(dim, a - i * n, b - a).to(device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def paired_blocks(pieces, devices, what: str = "the SwiGLU pairing") -> list:
    """Each model position's block of a weight whose last dimension is two
    halves [a | b] of width f each, stored as the rule places it: split
    into contiguous column blocks, so that block m holds part of a or of b
    only. Position m computes with [a_m | b_m] (columns [m f/M, (m+1) f/M)
    of a and of b), read from the positions that hold them: SwiGLU's
    [u | g], the shared experts' [u | g], the SSM's in_proj [x | z]."""
    nm = len(devices)
    f = pieces[0].shape[-1] * nm // 2
    if f % nm:
        raise ValueError(f"a half of width {f} is not divided by the {nm} "
                         f"model shards, which {what} needs")
    fl = f // nm
    out = [torch.cat([_take(pieces, m * fl, (m + 1) * fl, -1, dev),
                      _take(pieces, f + m * fl, f + (m + 1) * fl, -1,
                            dev)], -1)
           for m, dev in enumerate(devices)]
    if nm > 1:
        D.count("collective-permute", out[0], nm)
    return out


def mlp_apply_tp(p, xs, cfg: ModelConfig, devices, act=None) -> list:
    """Tensor-parallel MLP of one data row: `p` has "wi" and "wo" as lists
    of the model positions' pieces, `xs` the replicated input at each;
    returns each position's partial output (the sum is the MLP's). `act`
    overrides `cfg.mlp_act` (the MoE's shared experts are SwiGLU)."""
    act = act or cfg.mlp_act
    wis = paired_blocks(p["wi"], devices) if act == "swiglu" \
        else list(p["wi"])
    out = []
    for x, wi, wo in zip(xs, wis, p["wo"]):
        h = x @ wi.to(x.dtype)
        if act == "swiglu":
            u, g = torch.chunk(h, 2, dim=-1)
            h = u * silu(g)
        else:
            r = F.relu(h)
            h = r * r
        out.append(h @ wo.to(x.dtype))
    return out


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


def embed_tokens_tp(p, tokens, cfg: ModelConfig, devices) -> list:
    """The lookup of one data row, replicated at each model position.
    A tied table is vocab-sharded: each position looks up the ids of its
    range and writes zeros elsewhere, and the positions are summed (one
    nonzero term: exact). An untied table is whole at every position."""
    tabs = p["tok"]
    if not cfg.tie_embeddings:
        return [t[tokens.to(dev)] for t, dev in zip(tabs, devices)]
    n = tabs[0].shape[0]
    parts = []
    for m, (t, dev) in enumerate(zip(tabs, devices)):
        ids = tokens.to(dev) - m * n
        hit = (ids >= 0) & (ids < n)
        parts.append(t[ids.clamp(0, n - 1)]
                     * hit[..., None].to(t.dtype))
    return D.all_reduce(parts, devices)


def unembed_tp(p, xs, cfg: ModelConfig) -> list:
    """Each model position's block of the logits (B, S, V / M) from the
    replicated `xs`."""
    if cfg.tie_embeddings:
        return [x @ t.to(x.dtype).T for x, t in zip(xs, p["tok"])]
    return [x @ w.to(x.dtype) for x, w in zip(xs, p["out"])]


def softmax_xent_tp(logits, labels) -> torch.Tensor:
    """The summed (not averaged) masked next-token NLL of one data row
    from its vocab-sharded `logits` (a list over the model positions), on
    the first position's device: the max over the shards, the sum of
    exps, each label's logit from the shard holding it. The max is held
    constant under differentiation, so the gradient is the softmax's."""
    dev = logits[0].device
    ls = [x.float() for x in logits]
    n = ls[0].shape[-1]
    on = [dev] * len(ls)
    gmax = D.all_reduce([torch.amax(x, dim=-1).detach() for x in ls], on,
                        op=torch.maximum)[0]
    es, vs = [], []
    lab = labels.clamp(min=0)
    for m, x in enumerate(ls):
        xd = x.device
        es.append(torch.sum(torch.exp(x - gmax.to(xd)[..., None]), dim=-1))
        loc = lab.to(xd) - m * n
        hit = (loc >= 0) & (loc < n)
        v = torch.gather(x, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        vs.append(v * hit)
    se = D.all_reduce(es, on)[0]
    ll = D.all_reduce(vs, on)[0]
    lse = gmax + torch.log(se)
    mask = labels.to(dev) >= 0
    return torch.sum((lse - ll) * mask)


def softmax_xent(logits, labels, vocab_size: int):
    """Mean next-token cross entropy; labels == -1 are masked."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels >= 0
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
