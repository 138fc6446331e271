"""Mamba2 mixer via SSD (state-space duality, arXiv:2405.21060), as the
reference's `repro/models/mamba2.py`.

Chunked algorithm: within a chunk the output is a masked quadratic form;
across chunks a small recurrent state (B, H, P, N) is carried by a loop
over the chunks. Decode is a pure recurrence: one state update a token,
written in place into the cache.

Rounding follows the reference step for step: `softplus` is jax's
`logaddexp(x, 0)` written out in the input's dtype, the depthwise conv
sums its four taps in the reference's order, the masked decay selects 0
above the diagonal (where `exp` may overflow) rather than multiplying by
the mask, before the `exp` as well as after it so that its gradient is
finite where the reference's is NaN (`intra_chunk_weight`), and every
cast to the activations' dtype sits where the reference writes it (the
intra-chunk weights, the state weights, the scan carry, the inter-chunk
decay). The reference's three-operand
einsums are contracted in the pairs jax's `einsum` picks for them.

Over a mesh (`*_tp`, one data row; lists hold one entry per "model"
position) the heads are split over "model", as the reference's rules
place d_inner, dt_proj's columns and the per-head vectors: in_proj's
columns [x | z] are paired per position (`layers.paired_blocks`),
bc_proj is replicated (one group), each position runs the SSD of its
heads alone, the gated norm sums its squares over "model", and out_proj
is row-parallel. The decode caches (conv channels, state heads) are per
head, so each position updates its own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models.layers import paired_blocks, silu
from repro_torch.models.pspec import PSpec

D_CONV = 4


def mamba_specs(cfg: ModelConfig):
    d, di, h, n = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    return dict(
        in_proj=PSpec((d, 2 * di), ("fsdp", "model")),       # x, z(gate)
        bc_proj=PSpec((d, 2 * n), ("fsdp", None)),           # B, C (1 group)
        dt_proj=PSpec((d, h), ("fsdp", "model")),
        conv_w=PSpec((D_CONV, di), (None, "model"), "small"),
        conv_b=PSpec((di,), ("model",), "zeros"),
        a_log=PSpec((h,), ("model",), "zeros"),
        d_skip=PSpec((h,), ("model",), "ones"),
        dt_bias=PSpec((h,), ("model",), "zeros"),
        norm_w=PSpec((di,), ("model",), "ones"),
        out_proj=PSpec((di, d), ("model", "fsdp")),
    )


def _replace_inf(x):
    return torch.where(torch.isinf(x), torch.zeros_like(x), x)


class _Softplus(torch.autograd.Function):
    """`jnp.logaddexp(x, 0)` with its custom JVP: the gradient is
    g · exp(x - out), each infinity replaced by 0 first."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_replace_inf(x) - _replace_inf(out))


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    rounded to x's dtype at each step (NaN passes through); its gradient
    is jax's (`_Softplus`)."""
    return _Softplus.apply(x)


def _conv_causal(x, w, b):
    """Depthwise causal conv. x: (B, L, di); w: (D_CONV, di)."""
    xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(D_CONV))
    return silu(out + b)


def _gated_norm(y, z, w, eps):
    y = y * silu(z)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    return (y * torch.rsqrt(var + eps).to(y.dtype)) * w


def intra_chunk_weight(decay, mask):
    """exp(decay) on and below the diagonal, 0 above it. Above the
    diagonal the exponent is positive and `exp` may overflow to inf. The
    reference selects 0 after the `exp` only (`where(mask, exp(decay),
    0)`), so its backward multiplies the zero cotangent by inf and gives
    NaN. Selecting the exponent's 0 before the `exp` as well keeps the
    forward bit for bit and makes the backward finite."""
    return torch.where(mask, torch.exp(torch.where(mask, decay, 0.0)), 0.0)


def ssd_chunked(x, dt, a_log, B, C, chunk: int):
    """SSD scan. x: (B, L, H, P); dt: (B, L, H) float32; B, C: (B, L, N)
    float32.

    Returns y: (B, L, H, P) and the final state (B, H, P, N), both in
    x's dtype. L must be a multiple of `chunk`, as the reference asserts.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD "
                         f"chunk {chunk}")
    nc = l // chunk
    dt_x = x.dtype
    a = -torch.exp(a_log.float())                         # (H,) negative
    dA = dt * a                                           # (B, L, H)
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dAc, dim=2)                        # (B, nc, Q, H)
    seg_end = cum[:, :, -1:, :]                           # chunk's decay

    # Intra-chunk: y_q = sum_{k<=q} C_q.B_k e^{cum_q-cum_k} dt_k x_k.
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    iq = torch.arange(chunk, device=x.device)
    mask = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    w = intra_chunk_weight(decay, mask)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    wgt = (cb[..., None] * w * dtc[:, :, None, :, :]).to(dt_x)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", wgt, xc)

    # Chunk states: S_c = sum_k e^{seg_end - cum_k} dt_k B_k x_k^T, its
    # outer product formed first over the smaller of (N, H) and (H, P).
    sdec = torch.exp(seg_end - cum)                       # (B,nc,Q,H)
    sw = (sdec * dtc).to(dt_x)
    Bx = Bc.to(dt_x)
    if p < n:
        states = torch.einsum("bckhp,bckn->bchpn", sw[..., None] * xc, Bx)
    else:
        states = torch.einsum("bckhp,bcknh->bchpn", xc,
                              Bx[..., :, None] * sw[..., None, :])

    # Inter-chunk recurrence over the nc chunks.
    chunk_dec = torch.exp(seg_end[:, :, 0, :]).to(dt_x)   # (B, nc, H)
    s_state = torch.zeros((b, h, p, n), dtype=dt_x, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_state)
        s_state = states[:, c] + chunk_dec[:, c, :, None, None] * s_state
    s_prevs = torch.stack(s_prevs, dim=1)                 # (B,nc,H,P,N)

    # Inter-chunk contribution: y_q += C_q . (e^{cum_q} S_prev).
    qdec = torch.exp(cum).to(dt_x)                        # (B,nc,Q,H)
    cs = torch.einsum("bchpn,bcqn->bchpq", s_prevs, Cc.to(dt_x))
    y_inter = cs.permute(0, 1, 4, 2, 3) * qdec[..., None]
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y, s_state


def _mixer_inputs(p, x):
    """The projections shared by train and decode: (xin, z, B, C, dt) with
    dt = softplus(...) in float32."""
    xz = x @ p["in_proj"].to(x.dtype)
    xin, z = torch.chunk(xz, 2, dim=-1)
    bc = x @ p["bc_proj"].to(x.dtype)
    B, C = torch.chunk(bc, 2, dim=-1)
    dt = softplus(x @ p["dt_proj"].to(x.dtype)
                  + p["dt_bias"].to(x.dtype)).float()
    return xin, z, B, C, dt


def _scan_heads(p, xin, B, C, dt, cfg: ModelConfig, heads: int):
    """The conv, SSD and skip of `heads` heads (all of them, or one model
    position's block): (y (B, L, heads·P) before the gated norm, the
    final SSD state, the conv's trailing D_CONV - 1 inputs)."""
    b, l, _ = xin.shape
    dt_x = xin.dtype
    conv_tail = xin[:, -(D_CONV - 1):, :]
    xin = _conv_causal(xin, p["conv_w"].to(dt_x), p["conv_b"].to(dt_x))
    xh = xin.reshape(b, l, heads, cfg.ssm_head_dim)
    y, st = ssd_chunked(xh, dt, p["a_log"], B.float(), C.float(),
                        cfg.ssm_chunk)
    y = y + xh * p["d_skip"].to(dt_x)[None, None, :, None]
    return y.reshape(b, l, heads * cfg.ssm_head_dim), st, conv_tail


def mamba_train(p, x, cfg: ModelConfig, with_state: bool = False):
    """x: (B, L, D) -> (B, L, D); with `with_state`, also the final SSD
    state and the conv's trailing D_CONV - 1 inputs, both bf16 (the
    reference's `Model._mamba_with_state`, the prefill of a decode
    cache)."""
    xin, z, B, C, dt = _mixer_inputs(p, x)
    y, st, conv_tail = _scan_heads(p, xin, B, C, dt, cfg, cfg.ssm_heads)
    y = _gated_norm(y, z, p["norm_w"].to(x.dtype), cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if with_state:
        return out, st.to(torch.bfloat16), conv_tail.to(torch.bfloat16)
    return out


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (B, D_CONV-1, d_inner) trailing inputs
    state: torch.Tensor    # (B, H, P, N)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, D_CONV - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=dtype, device=device))


def _step_heads(p, xin, B, C, dt, cache: MambaCache, cfg: ModelConfig,
                heads: int):
    """One decode step of `heads` heads (all, or one model position's
    block) against their cache, written in place: y (B, 1, heads·P)
    before the gated norm."""
    b = xin.shape[0]
    dt_x = xin.dtype
    window = torch.cat([cache.conv.to(dt_x), xin], dim=1)
    conv = sum(window[:, i] * p["conv_w"][i].to(dt_x)
               for i in range(D_CONV))
    xc = silu(conv + p["conv_b"].to(dt_x))[:, None]       # (B, 1, di)
    dt = dt[:, 0]                                         # (B, H)
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt * a)                               # (B, H)
    xh = xc[:, 0].reshape(b, heads, cfg.ssm_head_dim)
    upd = (dt.to(dt_x)[:, :, None] * xh)[..., None] \
        * B[:, 0].to(dt_x)[:, None, None, :]
    state = cache.state.to(dt_x) * dec[:, :, None, None].to(dt_x) + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(dt_x), state)
    y = y + xh * p["d_skip"].to(dt_x)[None, :, None]
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return y.reshape(b, 1, heads * cfg.ssm_head_dim)


def mamba_decode(p, x, cache: MambaCache, cfg: ModelConfig):
    """x: (B, 1, D) one token; an O(1) state update written into the
    cache's tensors in place."""
    xin, z, B, C, dt = _mixer_inputs(p, x)
    y = _step_heads(p, xin, B, C, dt, cache, cfg, cfg.ssm_heads)
    y = _gated_norm(y, z, p["norm_w"].to(x.dtype), cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), cache


# --- over a mesh ------------------------------------------------------------

def local_heads(cfg: ModelConfig, nm: int) -> int:
    """The SSM heads each of `nm` model positions holds; ValueError unless
    `nm` divides them (the blocks of d_inner, of dt_proj's columns and of
    the per-head vectors must name the same whole heads)."""
    if cfg.ssm_heads % nm:
        raise ValueError(f"{cfg.name}: {nm} model shards do not divide its "
                         f"{cfg.ssm_heads} SSM heads; each position's block "
                         "of d_inner must hold whole heads")
    return cfg.ssm_heads // nm


def _mixer_inputs_tp(p, xs, cfg: ModelConfig, devices) -> list:
    """Each model position's (x_m, z_m, B, C, dt_m): in_proj's columns
    paired as [x_m | z_m] (`layers.paired_blocks`), dt over its heads, B
    and C whole (one group, replicated)."""
    local_heads(cfg, len(devices))
    wxz = paired_blocks(p["in_proj"], devices, "the SSM's in_proj [x | z]")
    out = []
    for m, (x, w) in enumerate(zip(xs, wxz)):
        xin, z = torch.chunk(x @ w.to(x.dtype), 2, dim=-1)
        B, C = torch.chunk(x @ p["bc_proj"][m].to(x.dtype), 2, dim=-1)
        dt = softplus(x @ p["dt_proj"][m].to(x.dtype)
                      + p["dt_bias"][m].to(x.dtype)).float()
        out.append((xin, z, B, C, dt))
    return out


def _gated_norm_tp(ys, zs, ws, cfg: ModelConfig, devices) -> list:
    """`_gated_norm` over d_inner split across the model positions: the
    local sums of squares summed over "model" before the rsqrt."""
    gs = [y * silu(z) for y, z in zip(ys, zs)]
    sq = D.all_reduce([torch.sum(torch.square(g.float()), -1, keepdim=True)
                       for g in gs], devices)
    return [(g * torch.rsqrt(s / cfg.d_inner + cfg.norm_eps).to(g.dtype))
            * w.to(g.dtype) for g, s, w in zip(gs, sq, ws)]


def mamba_train_tp(p, xs, cfg: ModelConfig, devices,
                   with_state: bool = False):
    """The mixer of one data row over its model positions: `p` maps each
    weight to the positions' pieces (FSDP-gathered), `xs` is the
    replicated input. Each position runs the SSD of its heads with no
    communication; out_proj is row-parallel. Returns each position's
    partial output and, with `with_state`, its (state of its heads, conv
    tail of its channels), bf16."""
    hl = local_heads(cfg, len(devices))
    ys, zs, states = [], [], []
    for m, (xin, z, B, C, dt) in enumerate(_mixer_inputs_tp(p, xs, cfg,
                                                            devices)):
        pm = {k: v[m] for k, v in p.items()}
        y, st, tail = _scan_heads(pm, xin, B, C, dt, cfg, hl)
        ys.append(y)
        zs.append(z)
        states.append((st.to(torch.bfloat16), tail.to(torch.bfloat16)))
    hs = _gated_norm_tp(ys, zs, p["norm_w"], cfg, devices)
    outs = [h @ w.to(h.dtype) for h, w in zip(hs, p["out_proj"])]
    return (outs, states) if with_state else outs


def mamba_decode_tp(p, xs, caches, cfg: ModelConfig, devices) -> list:
    """One decode step of one data row: `caches[m]` is position m's
    MambaCache (its channels of the conv window, its heads of the state),
    written in place; these are per head, so no block needs another's.
    Returns each position's partial output."""
    hl = local_heads(cfg, len(devices))
    ys, zs = [], []
    for m, ((xin, z, B, C, dt), c) in enumerate(zip(
            _mixer_inputs_tp(p, xs, cfg, devices), caches)):
        pm = {k: v[m] for k, v in p.items()}
        ys.append(_step_heads(pm, xin, B, C, dt, c, cfg, hl))
        zs.append(z)
    hs = _gated_norm_tp(ys, zs, p["norm_w"], cfg, devices)
    return [h @ w.to(h.dtype) for h, w in zip(hs, p["out_proj"])]
