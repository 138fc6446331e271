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
the mask, and every cast to the activations' dtype sits where the
reference writes it (the intra-chunk weights, the state weights, the
scan carry, the inter-chunk decay). The reference's three-operand
einsums are contracted in the pairs jax's `einsum` picks for them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import silu
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


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    rounded to x's dtype at each step (NaN passes through)."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _conv_causal(x, w, b):
    """Depthwise causal conv. x: (B, L, di); w: (D_CONV, di)."""
    xp = F.pad(x, (0, 0, D_CONV - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(D_CONV))
    return silu(out + b)


def _gated_norm(y, z, w, eps):
    y = y * silu(z)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    return (y * torch.rsqrt(var + eps).to(y.dtype)) * w


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

    # Intra-chunk: y_q = sum_{k<=q} C_q.B_k e^{cum_q-cum_k} dt_k x_k. Above
    # the diagonal the exponent is positive and may overflow: select 0.
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    iq = torch.arange(chunk, device=x.device)
    mask = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    w = torch.where(mask, torch.exp(decay), 0.0)
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


def mamba_train(p, x, cfg: ModelConfig, with_state: bool = False):
    """x: (B, L, D) -> (B, L, D); with `with_state`, also the final SSD
    state and the conv's trailing D_CONV - 1 inputs, both bf16 (the
    reference's `Model._mamba_with_state`, the prefill of a decode
    cache)."""
    b, l, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    xin, z, B, C, dt = _mixer_inputs(p, x)
    conv_tail = xin[:, -(D_CONV - 1):, :]
    xin = _conv_causal(xin, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    xh = xin.reshape(b, l, h, pd)
    y, st = ssd_chunked(xh, dt, p["a_log"], B.float(), C.float(),
                        cfg.ssm_chunk)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, l, h * pd)
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


def mamba_decode(p, x, cache: MambaCache, cfg: ModelConfig):
    """x: (B, 1, D) one token; an O(1) state update written into the
    cache's tensors in place."""
    b = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    dt_x = x.dtype
    xin, z, B, C, dt = _mixer_inputs(p, x)
    window = torch.cat([cache.conv.to(dt_x), xin], dim=1)
    conv = sum(window[:, i] * p["conv_w"][i].to(dt_x)
               for i in range(D_CONV))
    xc = silu(conv + p["conv_b"].to(dt_x))[:, None]       # (B, 1, di)
    dt = dt[:, 0]                                         # (B, H)
    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt * a)                               # (B, H)
    xh = xc[:, 0].reshape(b, h, pd)
    upd = (dt.to(dt_x)[:, :, None] * xh)[..., None] \
        * B[:, 0].to(dt_x)[:, None, None, :]
    state = cache.state.to(dt_x) * dec[:, :, None, None].to(dt_x) + upd
    y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(dt_x), state)
    y = y + xh * p["d_skip"].to(dt_x)[None, :, None]
    y = y.reshape(b, 1, h * pd)
    y = _gated_norm(y, z, p["norm_w"].to(dt_x), cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_x)
    cache.conv.copy_(window[:, 1:])
    cache.state.copy_(state)
    return out, cache
