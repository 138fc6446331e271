"""Multi-head Latent Attention (DeepSeek-V2), as the reference's
`repro/models/mla.py`. K and V are compressed into a `kv_lora_rank`
latent plus one RoPE key shared by the heads; the decode cache holds only
the latent and the shared key.

K is [nope | shared rope], of head dim nd + rd (192 at full width). For
the shared chunked attention V is padded to that head dim and sliced back
to vd (128) after; the attention scale is (nd + rd) ** -0.5, in prefill
and decode alike. Decode expands the whole latent cache through `w_uk` and
`w_uv` at every step, the reference's cost.

The cache is written in place at a host-int `pos`; a write at or past its
length raises (`attention.check_cache_room`).

Over a mesh (`*_tp`) the heads of w_q, w_uk, w_uv and wo are split over
"model" and every position computes the whole latent (w_dkv and kv_norm
are replicated); the latent cache is sequence-sharded ("sp"), see
`mla_decode_tp` for its layout.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models.attention import (NEG_INF, _in_dtype, _out_proj,
                                          _proj, check_cache_room,
                                          chunked_attention, combine_blocks)
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.pspec import PSpec


def mla_specs(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    nd, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    return dict(
        w_dkv=PSpec((d, r + rd), ("fsdp", None)),
        kv_norm=PSpec((r,), (None,), "ones"),
        w_uk=PSpec((r, h, nd), ("fsdp", "model", None)),
        w_uv=PSpec((r, h, vd), ("fsdp", "model", None)),
        w_q=PSpec((d, h, nd + rd), ("fsdp", "model", None)),
        wo=PSpec((h, vd, d), ("model", None, "fsdp")),
    )


def _latent(p, x, cfg: ModelConfig, positions):
    """x (B, S, D) -> the normed latent (B, S, r) and the roped shared
    key (B, S, rd)."""
    dkv = x @ p["w_dkv"].to(x.dtype)
    c_kv, k_rope = torch.split(dkv, [cfg.kv_lora_rank,
                                     dkv.shape[-1] - cfg.kv_lora_rank], -1)
    c_kv = rmsnorm(c_kv, p["kv_norm"].to(x.dtype), cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _expand_kv(p, c_kv, k_rope, cfg: ModelConfig, dtype):
    """Latent -> per-head K (B, S, H, nd + rd) and V (B, S, H, vd)."""
    k_nope = _proj(c_kv, p["w_uk"].to(dtype))
    v = _proj(c_kv, p["w_uv"].to(dtype))
    k_rope_b = k_rope[:, :, None, :].expand(
        k_nope.shape[:3] + (cfg.qk_rope_head_dim,))
    return torch.cat([k_nope, k_rope_b], dim=-1), v


def _queries(p, x, cfg: ModelConfig, positions):
    q = _proj(x, p["w_q"])
    nd = cfg.qk_nope_head_dim
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _attend(p, x, cfg: ModelConfig, positions):
    """MLA of the heads `p` holds (all of them, or one model position's
    block) over the full sequence: (output, the latent (c_kv, k_rope))."""
    q = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latent(p, x, cfg, positions)
    k, v = _expand_kv(p, c_kv, k_rope, cfg, x.dtype)
    # chunked_attention takes (B, S, Kv, hd) with GQA groups; MLA expands
    # to full heads (Kv == H). V is padded to K's head dim, then sliced.
    cfg_attn = dataclasses.replace(
        cfg, head_dim=cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    vd = v.shape[-1]
    if vd != k.shape[-1]:
        v = F.pad(v, (0, k.shape[-1] - vd))
    out = chunked_attention(q, k, v, cfg_attn, causal=True)[..., :vd]
    return _out_proj(out, p["wo"]), (c_kv, k_rope)


def mla_train(p, x, cfg: ModelConfig):
    """Causal MLA over the full sequence (forward / prefill); returns the
    output and the latent (c_kv, k_rope) a decode cache keeps."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return _attend(p, x, cfg, positions)


class MLACache(NamedTuple):
    c_kv: torch.Tensor      # (B, Smax, kv_lora_rank)
    k_rope: torch.Tensor    # (B, Smax, rope_dim)
    pos: int


def init_mla_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, seq, cfg.qk_rope_head_dim), dtype=dtype,
                           device=device),
        pos=0)


def mla_decode(p, x, cache: MLACache, cfg: ModelConfig):
    """One-token decode. x: (B, 1, D); the cache is written in place at
    `cache.pos`."""
    b = x.shape[0]
    pos = int(cache.pos)
    smax = cache.c_kv.shape[1]
    check_cache_room(pos, smax)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = _queries(p, x, cfg, positions)                 # (B, 1, H, nd+rd)
    c_new, kr_new = _latent(p, x, cfg, positions)
    cache.c_kv[:, pos] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, pos] = kr_new[:, 0].to(cache.k_rope.dtype)

    # Score against the whole expanded latent cache.
    k, v = _expand_kv(p, cache.c_kv.to(q.dtype), cache.k_rope.to(q.dtype),
                      cfg, q.dtype)
    scale = _in_dtype(1.0 / ((cfg.qk_nope_head_dim
                              + cfg.qk_rope_head_dim) ** 0.5), q.dtype)
    s = torch.einsum("bohk,bshk->bhso", q, k)[..., 0] * scale  # (B, H, Smax)
    mask = torch.arange(smax, device=x.device) <= pos
    s = torch.where(mask, s.float(), NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhs,bshn->bhn", w, v)[:, None]   # (B, 1, H, vd)
    return _out_proj(out, p["wo"]), cache._replace(pos=pos + 1)


# --- over a mesh ------------------------------------------------------------

def mla_train_tp(p, xs, cfg: ModelConfig):
    """MLA of one data row over its model positions: `p` is a list of each
    position's weights (its block of the heads of w_q, w_uk, w_uv and wo;
    w_dkv and kv_norm whole), `xs` the replicated input. Each position
    computes the whole latent and attends with its heads. Returns each
    position's partial output and its (whole) latent."""
    b, s, _ = xs[0].shape
    positions = torch.arange(s, device=xs[0].device).expand(b, s)
    outs, lats = [], []
    for pm, x in zip(p, xs):
        y, lat = _attend(pm, x, cfg, positions.to(x.device))
        outs.append(y)
        lats.append(lat)
    return outs, lats


def mla_decode_tp(p, xs, caches, pos: int, cfg: ModelConfig, devices):
    """One-token MLA decode of one data row. `caches[m]` is position m's
    MLACache over its block of the sequence ("sp"), written in place where
    it owns `pos`.

    Layout: a latent block stays where it was written and is expanded
    there through every head's w_uk and w_uv (gathered over "model"), its
    partial softmax combined with the other blocks' by their log-sum-exp
    (`attention.combine_blocks`), as the dense "sp" cache is. The other
    layout, each position's heads against every block, would move the
    latent blocks instead; they grow with the batch and the sequence,
    while the two weights are a fixed r·H·(nd + vd) a layer, so the
    weights move. Returns each position's partial output."""
    b = xs[0].shape[0]
    nm = len(xs)
    blk = caches[0].c_kv.shape[1]
    check_cache_room(pos, blk * nm)
    positions = torch.full((b, 1), pos, dtype=torch.int64)
    qs = [_queries(pm, x, cfg, positions.to(x.device))
          for pm, x in zip(p, xs)]
    own, at = divmod(pos, blk)
    c = caches[own]
    c_new, kr_new = _latent(p[own], xs[own], cfg,
                            positions.to(xs[own].device))
    c.c_kv[:, at] = c_new[:, 0].to(c.c_kv.dtype)
    c.k_rope[:, at] = kr_new[:, 0].to(c.k_rope.dtype)

    qall = D.all_gather(qs, 2, devices)                  # (B, 1, H, nd+rd)
    wuk = D.all_gather([pm["w_uk"] for pm in p], 1, devices)
    wuv = D.all_gather([pm["w_uv"] for pm in p], 1, devices)
    scale = _in_dtype(1.0 / ((cfg.qk_nope_head_dim
                              + cfg.qk_rope_head_dim) ** 0.5), qs[0].dtype)
    parts = []                          # (max, sum, weighted V) a block
    for m, (q, cm, uk, uv) in enumerate(zip(qall, caches, wuk, wuv)):
        k, v = _expand_kv(dict(w_uk=uk, w_uv=uv), cm.c_kv.to(q.dtype),
                          cm.k_rope.to(q.dtype), cfg, q.dtype)
        sc = torch.einsum("bohk,bshk->bhso", q, k)[..., 0] * scale
        mask = m * blk + torch.arange(blk, device=q.device) <= pos
        sc = torch.where(mask, sc.float(), NEG_INF)
        mx = torch.amax(sc, dim=-1)
        e = torch.exp(sc - mx[..., None])
        parts.append((mx, torch.sum(e, dim=-1),
                      torch.einsum("bhs,bshn->bhn", e, v.float())))
    hl = qall[0].shape[2] // nm
    return [_out_proj(o.to(q.dtype)[:, None, m * hl:(m + 1) * hl], pm["wo"])
            for m, (pm, q, o) in enumerate(zip(p, qs, combine_blocks(
                parts, devices)))]
