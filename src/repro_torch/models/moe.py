"""Mixture-of-Experts layer: top-k routing and capacity-based dispatch by
grouped one-hot einsums, as the reference writes it
(`repro/models/moe.py`).

Tokens are split into groups of `min(moe_group, B·S)`. A token's slot at
the expert of its rank-k choice counts the earlier tokens of its group
whose rank-k choice was that expert (a cumsum over the group for each rank
apart), and a slot at or past `cap = max(1, int(g·k/E·capacity_factor))`
is dropped. Two tokens routed to one expert at different ranks can so
share a slot: the expert runs on the sum of their activations, and each
token gets the expert's output of that sum at its own router weight, so a
token's output depends on the rest of its group. At decode (one token a
sequence) a batch of 4 gives g = 4 and cap = 1 for deepseek's 64 experts.
These are the reference's semantics, kept. The dispatch runs every expert
on its capacity slots, so a decode step reads every expert's weights.

Supports DeepSeek-style shared experts and Arctic's dense residual, and
returns the Switch-style load-balancing `aux`.

Routing ties: the router's logits are computed in the activations' dtype
(bf16 when serving), so two experts can tie exactly; `jax.lax.top_k`
then puts the lower expert index first, which `top_k` keeps (a stable
descending sort), where `torch.topk` promises no order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_specs, silu
from repro_torch.models.pspec import PSpec


def moe_specs(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    out = dict(
        router=PSpec((d, e), ("fsdp", None), "small"),
        wi=PSpec((e, d, 2 * f), ("model", "fsdp", None)),
        wo=PSpec((e, f, d), ("model", None, "fsdp")),
    )
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        out["shared_wi"] = PSpec((d, 2 * fs), ("fsdp", "model"))
        out["shared_wo"] = PSpec((fs, d), ("model", "fsdp"))
    if cfg.dense_residual:
        out["dense"] = mlp_specs(cfg)
    return out


def top_k(x, k: int):
    """The k largest of the last axis, largest first, ties broken by the
    lower index (`jax.lax.top_k`'s order): (values, indices)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def group_size(cfg: ModelConfig, t: int) -> int:
    """The dispatch group of `t` tokens; raises where the reference's
    `assert t % g == 0` fails (t > moe_group and not a multiple of it)."""
    g = min(cfg.moe_group, t)
    if t % g:
        raise ValueError(f"{t} tokens do not split into MoE dispatch groups "
                         f"of {g} (moe_group {cfg.moe_group}); B·S must be "
                         "at most moe_group or a multiple of it")
    return g


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> ((B, S, D), aux)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    g = group_size(cfg, t)
    ng = t // g
    cap = max(1, int(g * k / e * cfg.capacity_factor))

    logits = tokens @ p["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = top_k(probs, k)                          # (T, k)
    topw = topw / torch.sum(topw, -1, keepdim=True)       # renormalize

    # Grouped one-hot dispatch with per-(group, expert) capacity.
    gi = topi.reshape(ng, g, k)
    gw = topw.reshape(ng, g, k)
    onehot = F.one_hot(gi, e).float()                     # (ng, g, k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot            # slots used before
    slot = torch.einsum("ngke,ngke->ngk", pos, onehot)    # (ng, g, k)
    keep = slot < cap
    # `jax.nn.one_hot` of a float slot: slots >= cap give zero rows.
    slot_oh = (slot[..., None] == torch.arange(cap, device=x.device)).float() \
        * keep[..., None]
    # dispatch[n, g, e, c] in {0,1}; combine carries router weights.
    dispatch = torch.einsum("ngke,ngkc->ngec", onehot, slot_oh)
    combine = torch.einsum("ngke,ngkc->ngec", gw[..., None] * onehot,
                           slot_oh)

    xg = tokens.reshape(ng, g, d)
    xe = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)
    hidden = torch.einsum("necd,edf->necf", xe, p["wi"].to(x.dtype))
    u, gate = torch.chunk(hidden, 2, dim=-1)
    hidden = u * silu(gate)
    ye = torch.einsum("necf,efd->necd", hidden, p["wo"].to(x.dtype))
    y = torch.einsum("ngec,necd->ngd", combine.to(x.dtype), ye)
    y = y.reshape(b, s, d)

    if cfg.num_shared_experts:
        h = x @ p["shared_wi"].to(x.dtype)
        u2, g2 = torch.chunk(h, 2, dim=-1)
        y = y + (u2 * silu(g2)) @ p["shared_wo"].to(x.dtype)
    if cfg.dense_residual:
        y = y + mlp_apply(p["dense"], x, cfg)

    # Load-balancing auxiliary loss (Switch-style).
    me = torch.mean(onehot.reshape(-1, k, e).sum(1), dim=0)
    pe = torch.mean(probs, dim=0)
    aux = e * torch.sum(me * pe)
    return y, aux
