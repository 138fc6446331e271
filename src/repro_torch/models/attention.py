"""GQA attention: chunked (flash-style) causal attention for prefill and
the full forward, and single-token decode against a KV cache.

Query heads are padded to a multiple of 16 (`ModelConfig.padded_heads`,
yi: 56 -> 64); the padded heads are live weights, and GQA's group size
is `padded_heads // num_kv_heads`, as in the reference.

Rounding follows the reference step for step. In `chunked_attention` the
scores are scaled in the compute dtype and then cast to float32; the
running max and sum stay float32, while the accumulator is in the compute
dtype and the probabilities and the correction are cast to it before they
enter it. Decode divides the scores by sqrt(hd) in the compute dtype
before a float32 softmax.

Caches are updated in place: `attend_decode` writes the new token's K/V
into the cache tensors at `pos` (the reference's donated
`dynamic_update_slice`) and returns a cache with `pos + 1`. `pos` is a
Python int, so the write needs no device read. A write at or past the
cache's length raises, where the reference's clamped slice would silently
overwrite the last slot.

Over a mesh (`*_tp`, one data row; lists hold one entry per "model"
position): each position computes its own block of the query heads and
the row-parallel part of `wo` (a partial sum). Its K/V heads are its own
block when the rule puts them over "model" (`kv_logical`), else every
position computes all of them and reads the group its query heads use.
The decode cache is sequence-sharded ("sp"): each position holds a block
of the positions of every head, the new token's K/V go to the block that
owns `pos`, and the blocks' partial softmaxes are combined by their
log-sum-exp (`combine_blocks`, which MLA's latent cache shares).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models.pspec import PSpec
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def kv_logical(cfg: ModelConfig):
    return "model" if cfg.num_kv_heads % 16 == 0 else None


def attn_specs(cfg: ModelConfig):
    d, hp, kv, hd = (cfg.d_model, cfg.padded_heads, cfg.num_kv_heads,
                     cfg.head_dim_)
    kvl = kv_logical(cfg)
    out = dict(
        wq=PSpec((d, hp, hd), ("fsdp", "model", None)),
        wk=PSpec((d, kv, hd), ("fsdp", kvl, None)),
        wv=PSpec((d, kv, hd), ("fsdp", kvl, None)),
        wo=PSpec((hp, hd, d), ("model", None, "fsdp")),
    )
    if cfg.qkv_bias:
        out.update(
            bq=PSpec((hp, hd), ("model", None), "zeros"),
            bk=PSpec((kv, hd), (kvl, None), "zeros"),
            bv=PSpec((kv, hd), (kvl, None), "zeros"),
        )
    return out


def _proj(x, w):
    """(B, S, D) x (D, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _qkv(p, x, cfg: ModelConfig, positions, rope=True):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """(B, S, H, hd) x (H, hd, D) -> (B, S, D)."""
    h, hd, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * hd, d)


def _in_dtype(x: float, dtype) -> float:
    """`x` rounded to `dtype`: the reference scales by a Python float, which
    jax casts to the array's dtype before the product."""
    return torch.tensor(x, dtype=dtype).item()


def chunked_attention(q, k, v, cfg: ModelConfig, *, causal: bool,
                      q_offset=0):
    """Online-softmax attention, looping over KV chunks.

    q: (B, Sq, H, hd); k, v: (B, Sk, Kv, hd). Supports GQA (H % Kv == 0).
    Memory: O(Sq * chunk) scores — never materializes (Sq, Sk).
    """
    b, sq, h, hd = q.shape
    sk0, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(cfg.attn_chunk, sk0)
    nch = -(-sk0 // chunk)
    dt = q.dtype
    scale = _in_dtype(1.0 / (cfg.head_dim_ ** 0.5), dt)
    dev = q.device

    qg = q.reshape(b, sq, kvh, g, hd)
    qpos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=dt, device=dev)
    for j in range(nch):
        # The last chunk is short when sk is not a chunk multiple; the
        # reference pads it with zero keys that the mask then removes.
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        c = kj.shape[1]
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, kj) * scale
        s = s.float()
        if causal:
            kpos = j * chunk + torch.arange(c, device=dev)
            mask = qpos[:, None] >= kpos[None, :]                  # (Sq, C)
            s = torch.where(mask, s, NEG_INF)
        if c < chunk:
            # The padded keys' columns: score NEG_INF, as the reference's.
            s = torch.cat([s, s.new_full(s.shape[:-1] + (chunk - c,),
                                         NEG_INF)], -1)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p[..., :c].to(dt), vj)
        acc = acc * corr[..., None].to(dt) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(dt)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)  # (B,Sq,H,hd)


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, Smax, Kv, hd)
    v: torch.Tensor
    pos: int            # current length


class Int8KVCache(NamedTuple):
    """Quantized decode cache: int8 values + per-(token, head) scales."""
    k: torch.Tensor         # (B, Smax, Kv, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor   # (B, Smax, Kv) f32
    v_scale: torch.Tensor
    pos: int


def _quantize_kv(x):
    """(B, S, Kv, hd) -> int8 values + per-(token, head) scale. Rounds
    half to even, as `jnp.round` does."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attend_train(p, x, cfg: ModelConfig):
    """Causal self-attention over the full sequence (forward / prefill);
    returns the output and the (roped) K/V."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, cfg, causal=True)
    return _out_proj(out, p["wo"]), (k, v)


def check_cache_room(pos: int, smax: int) -> None:
    """Raise unless a decode write at `pos` fits a cache of `smax`."""
    if pos >= smax:
        raise ValueError(f"decode at position {pos} is past the end of a "
                         f"KV cache of length {smax}; size the caches with "
                         "init_caches(batch, seq) for every position")


def attend_decode(p, x, cache, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D); cache: KVCache or Int8KVCache,
    written in place at `cache.pos`."""
    b = x.shape[0]
    pos = int(cache.pos)
    smax = cache.k.shape[1]
    check_cache_room(pos, smax)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    quant = isinstance(cache, Int8KVCache)

    if quant:
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        cache.k[:, pos] = k_q[:, 0]
        cache.v[:, pos] = v_q[:, 0]
        cache.k_scale[:, pos] = k_s[:, 0]
        cache.v_scale[:, pos] = v_s[:, 0]
        k_r = cache.k.to(q.dtype) * cache.k_scale[..., None].to(q.dtype)
        v_r = cache.v.to(q.dtype) * cache.v_scale[..., None].to(q.dtype)
    else:
        cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
        k_r, v_r = cache.k.to(q.dtype), cache.v.to(q.dtype)

    h, kvh, hd = q.shape[2], k_r.shape[2], q.shape[3]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_r) / _in_dtype(
        cfg.head_dim_ ** 0.5, q.dtype)
    mask = torch.arange(smax, device=x.device) <= pos
    s = torch.where(mask, s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, v_r).reshape(b, 1, h, hd)
    y = _out_proj(out, p["wo"])
    return y, cache._replace(pos=pos + 1)


def init_decode_cache(cfg: ModelConfig, batch: int, seq: int,
                      dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, seq, cfg.num_kv_heads, cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), pos=0)


# --- over a mesh ------------------------------------------------------------

def kv_range(cfg: ModelConfig, m: int, nm: int) -> tuple:
    """[lo, hi) of the K/V heads that model position m's query heads read
    (its block of `padded_heads`), when K/V are not sharded."""
    hq = cfg.padded_heads // nm
    g = cfg.padded_heads // cfg.num_kv_heads
    if (hq % g if hq >= g else g % hq):
        raise ValueError(f"{nm} model shards of {cfg.padded_heads} query "
                         f"heads do not align with GQA groups of {g}")
    return (m * hq) // g, (m * hq + hq - 1) // g + 1


def _qkv_tp(p, xs, cfg: ModelConfig, positions):
    """Each position's (q, k, v) from its weights; positions (B, S)."""
    return [_qkv(pm, x, cfg, positions.to(x.device))
            for pm, x in zip(p, xs)]


def _own_kv(k, v, cfg: ModelConfig, m: int, nm: int) -> tuple:
    """The K/V heads position m's query heads read: all it holds under a
    "model" rule, else its GQA groups' range of the whole set."""
    if kv_logical(cfg) is not None:
        return k, v
    lo, hi = kv_range(cfg, m, nm)
    return k[:, :, lo:hi], v[:, :, lo:hi]


def attend_train_tp(p, xs, cfg: ModelConfig, causal: bool = True):
    """Self-attention of one data row over its model positions (causal,
    or bidirectional for the enc-dec's encoder): `p` is a list of each
    position's weights, `xs` the replicated input. Returns each
    position's partial output and its (k, v): its own head block under a
    "model" rule, else all heads."""
    b, s, _ = xs[0].shape
    nm = len(xs)
    positions = torch.arange(s, device=xs[0].device).expand(b, s)
    outs, kvs = [], []
    for m, (pm, (q, k, v)) in enumerate(zip(p, _qkv_tp(p, xs, cfg,
                                                       positions))):
        kq, vq = _own_kv(k, v, cfg, m, nm)
        out = chunked_attention(q, kq, vq, cfg, causal=causal)
        outs.append(_out_proj(out, pm["wo"]))
        kvs.append((k, v))
    return outs, kvs


def cross_attend_tp(p, xs, enc, cfg: ModelConfig) -> list:
    """The enc-dec's cross-attention of one data row: each position's
    query heads (its block of "model") against K/V projected from the
    encoder output `enc` (replicated at each position, as `enc_kv_from`
    reads it gathered), no RoPE, bidirectional. Returns each position's
    partial output."""
    nm = len(xs)
    outs = []
    for m, (pm, x, e) in enumerate(zip(p, xs, enc)):
        q = _proj(x, pm["wq"])
        k, v = _own_kv(_proj(e, pm["wk"]), _proj(e, pm["wv"]), cfg, m, nm)
        out = chunked_attention(q, k.to(q.dtype), v.to(q.dtype), cfg,
                                causal=False)
        outs.append(_out_proj(out, pm["wo"]))
    return outs


def cache_blocks(kvs, cfg: ModelConfig, devices) -> list:
    """Prefill's K/V as the "sp" cache: position m's (k, v) of every head
    over its block of the sequence."""
    if kv_logical(cfg) is not None:
        ks = D.all_gather([k for k, _ in kvs], 2, devices)
        vs = D.all_gather([v for _, v in kvs], 2, devices)
    else:
        ks, vs = [k for k, _ in kvs], [v for _, v in kvs]
    nm = len(devices)
    return [(k.chunk(nm, 1)[m], v.chunk(nm, 1)[m])
            for m, (k, v) in enumerate(zip(ks, vs))]


def attend_decode_tp(p, xs, caches, pos: int, cfg: ModelConfig, devices):
    """One-token decode of one data row. `caches[m]` is position m's
    KVCache or Int8KVCache over its block of the sequence, written in
    place where it owns `pos`. Returns each position's partial output."""
    b = xs[0].shape[0]
    nm = len(xs)
    blk = caches[0].k.shape[1]
    check_cache_room(pos, blk * nm)
    positions = torch.full((b, 1), pos, dtype=torch.int64)
    qkv = _qkv_tp(p, xs, cfg, positions)
    qs = D.all_gather([q for q, _, _ in qkv], 2, devices)
    if kv_logical(cfg) is not None:
        ks = D.all_gather([k for _, k, _ in qkv], 2, devices)
        vs = D.all_gather([v for _, _, v in qkv], 2, devices)
    else:
        ks, vs = [k for _, k, _ in qkv], [v for _, _, v in qkv]
    own, at = divmod(pos, blk)
    c = caches[own]
    if isinstance(c, Int8KVCache):
        k_q, k_s = _quantize_kv(ks[own])
        v_q, v_s = _quantize_kv(vs[own])
        c.k[:, at] = k_q[:, 0]
        c.v[:, at] = v_q[:, 0]
        c.k_scale[:, at] = k_s[:, 0]
        c.v_scale[:, at] = v_s[:, 0]
    else:
        c.k[:, at] = ks[own][:, 0].to(c.k.dtype)
        c.v[:, at] = vs[own][:, 0].to(c.v.dtype)

    hp, hd = qs[0].shape[2], qs[0].shape[3]
    kvh = cfg.num_kv_heads
    parts = []                          # (max, sum, weighted V) a block
    for m, (q, c) in enumerate(zip(qs, caches)):
        if isinstance(c, Int8KVCache):
            k_r = c.k.to(q.dtype) * c.k_scale[..., None].to(q.dtype)
            v_r = c.v.to(q.dtype) * c.v_scale[..., None].to(q.dtype)
        else:
            k_r, v_r = c.k.to(q.dtype), c.v.to(q.dtype)
        qg = q.reshape(b, kvh, hp // kvh, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qg, k_r) / _in_dtype(
            cfg.head_dim_ ** 0.5, q.dtype)
        mask = m * blk + torch.arange(blk, device=q.device) <= pos
        s = torch.where(mask, s.float(), NEG_INF)
        mx = torch.amax(s, dim=-1)
        e = torch.exp(s - mx[..., None])
        parts.append((mx, torch.sum(e, dim=-1),
                      torch.einsum("bkgs,bskh->bkgh", e, v_r.float())))
    hq = hp // nm
    return [_out_proj(o.to(q.dtype).reshape(b, 1, hp, hd)
                      [:, :, m * hq:(m + 1) * hq], pm["wo"])
            for m, (pm, q, o) in enumerate(zip(p, qs, combine_blocks(
                parts, devices)))]


def combine_blocks(parts, devices) -> list:
    """The attention output over every block of an "sp" cache, at each
    position: `parts[j]` is block j's (row max, sum of exps, exp-weighted
    values), float32; they are combined by their log-sum-exp on each
    device (once a device)."""
    made = {}
    for dev in devices:
        if dev not in made:
            mxs = [x.to(dev) for x, _, _ in parts]
            top = torch.amax(torch.stack(mxs), 0)
            den = num = None
            for mx, (_, l, o) in zip(mxs, parts):
                w = torch.exp(mx - top)
                den = l.to(dev) * w if den is None else den + l.to(dev) * w
                t = o.to(dev) * w[..., None]
                num = t if num is None else num + t
            made[dev] = num / den[..., None]
    out = [made[d] for d in devices]
    if len(parts) > 1:                  # every block's parts, everywhere
        D.count("all-gather", [x for part in parts for x in part],
                len(devices))
        D.note_shared(out)
    return out
