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

Over a mesh (`moe_apply_tp`) the experts are split over "model" (the
reference's `wi`/`wo` rules), the shared experts and the dense residual
are column- then row-parallel, and the dispatch groups stay the global
batch's (see its docstring).

Routing ties: the router's logits are computed in the activations' dtype
(bf16 when serving), so two experts can tie exactly; `jax.lax.top_k`
then puts the lower expert index first, which `top_k` keeps (a stable
descending sort), where `torch.topk` promises no order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models.layers import (mlp_apply, mlp_apply_tp, mlp_specs,
                                       silu)
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


class Routing(NamedTuple):
    """The reference's routing of T tokens in `ng` dispatch groups."""
    probs: torch.Tensor       # (T, E) float32
    onehot: torch.Tensor      # (ng, g, k, E) each rank's expert
    slot: torch.Tensor        # (ng, g, k) capacity slot at that expert
    keep: torch.Tensor        # (ng, g, k) slot < cap
    dispatch: torch.Tensor    # (ng, g, E, cap) in {0, 1}
    combine: torch.Tensor     # (ng, g, E, cap) router weights


def route(tokens, router, cfg: ModelConfig, g: int) -> Routing:
    """Top-k routing of `tokens` (T, D) and the grouped one-hot dispatch
    with per-(group, expert) capacity, groups of `g` in token order."""
    e, k = cfg.num_experts, cfg.experts_per_token
    ng = tokens.shape[0] // g
    cap = max(1, int(g * k / e * cfg.capacity_factor))
    logits = tokens @ router.to(tokens.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    topw, topi = top_k(probs, k)                          # (T, k)
    topw = topw / torch.sum(topw, -1, keepdim=True)       # renormalize

    gi = topi.reshape(ng, g, k)
    gw = topw.reshape(ng, g, k)
    onehot = F.one_hot(gi, e).float()                     # (ng, g, k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot            # slots used before
    slot = torch.einsum("ngke,ngke->ngk", pos, onehot)    # (ng, g, k)
    keep = slot < cap
    # `jax.nn.one_hot` of a float slot: slots >= cap give zero rows.
    slot_oh = (slot[..., None] == torch.arange(cap, device=tokens.device)
               ).float() * keep[..., None]
    # dispatch[n, g, e, c] in {0,1}; combine carries router weights.
    dispatch = torch.einsum("ngke,ngkc->ngec", onehot, slot_oh)
    combine = torch.einsum("ngke,ngkc->ngec", gw[..., None] * onehot,
                           slot_oh)
    return Routing(probs, onehot, slot, keep, dispatch, combine)


def _experts(wi, wo, dispatch, combine, xg):
    """The experts of `wi` (e, D, 2f) and `wo` (e, f, D) on their slots of
    the groups `xg` (ng, g, D): their part of the combined output."""
    dt = xg.dtype
    xe = torch.einsum("ngec,ngd->necd", dispatch.to(dt), xg)
    hidden = torch.einsum("necd,edf->necf", xe, wi.to(dt))
    u, gate = torch.chunk(hidden, 2, dim=-1)
    hidden = u * silu(gate)
    ye = torch.einsum("necf,efd->necd", hidden, wo.to(dt))
    return torch.einsum("ngec,necd->ngd", combine.to(dt), ye)


def _load_sums(r: Routing, cfg: ModelConfig) -> tuple:
    """The aux's two sums over the tokens: each expert's top-k count and
    its router probability."""
    k, e = cfg.experts_per_token, cfg.num_experts
    return (torch.sum(r.onehot.reshape(-1, k, e).sum(1), dim=0),
            torch.sum(r.probs, dim=0))


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> ((B, S, D), aux)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(-1, d)
    g = group_size(cfg, tokens.shape[0])
    r = route(tokens, p["router"], cfg, g)
    y = _experts(p["wi"], p["wo"], r.dispatch, r.combine,
                 tokens.reshape(-1, g, d)).reshape(b, s, d)

    if cfg.num_shared_experts:
        h = x @ p["shared_wi"].to(x.dtype)
        u2, g2 = torch.chunk(h, 2, dim=-1)
        y = y + (u2 * silu(g2)) @ p["shared_wo"].to(x.dtype)
    if cfg.dense_residual:
        y = y + mlp_apply(p["dense"], x, cfg)

    # Load-balancing auxiliary loss (Switch-style).
    me = torch.mean(r.onehot.reshape(-1, k, e).sum(1), dim=0)
    pe = torch.mean(r.probs, dim=0)
    aux = e * torch.sum(me * pe)
    return y, aux


# --- over a mesh ------------------------------------------------------------

def _moe_row(p, hs, cfg: ModelConfig, devices, g: int) -> tuple:
    """The MoE of one data row's tokens `hs` (replicated at its model
    positions; `p` the positions' FSDP-gathered pieces): each position
    runs its block of the experts on their slots, and the shared experts
    and the dense residual tensor-parallel. Returns (each position's
    partial output, `_load_sums`, the routing)."""
    nm = len(devices)
    ne = cfg.num_experts // nm
    made = {}
    outs = []
    for m, (x, dev) in enumerate(zip(hs, devices)):
        b, s, d = x.shape
        if dev not in made:          # positions on one device share it
            made[dev] = route(x.reshape(-1, d), p["router"][m], cfg, g)
        r = made[dev]
        sl = slice(m * ne, (m + 1) * ne)
        outs.append(_experts(p["wi"][m], p["wo"][m], r.dispatch[:, :, sl],
                             r.combine[:, :, sl],
                             x.reshape(-1, g, d)).reshape(b, s, d))
    if cfg.num_shared_experts:
        sh = mlp_apply_tp(dict(wi=p["shared_wi"], wo=p["shared_wo"]), hs,
                          cfg, devices, act="swiglu")
        outs = [y + z for y, z in zip(outs, sh)]
    if cfg.dense_residual:
        outs = [y + z for y, z in zip(outs, mlp_apply_tp(p["dense"], hs, cfg,
                                                         devices))]
    r = made[devices[0]]
    return outs, _load_sums(r, cfg), r


def moe_apply_tp(p_rows, hs_rows, cfg: ModelConfig, devs_rows,
                 split: bool) -> tuple:
    """The MoE over the data rows: `hs_rows[r]` row r's input replicated at
    its model positions, `p_rows[r]` its positions' weights. Experts are
    over "model"; each position's output is a partial sum over "model".

    The dispatch groups are the reference's: `min(moe_group, B·S)` tokens
    of the whole batch in its flattened (B, S) order, rows in order when
    `split` (each row a block of the batch), else each row holds the whole
    batch. Where every row holds whole groups, each routes its own; where
    a group spans rows (a decode batch of B < moe_group tokens, say),
    every row gathers the batch's tokens over the data rows, routes and
    runs all of it, and keeps its own tokens' outputs, so that slots,
    capacity drops and slot collisions are the global group's. The aux's
    two means run over the whole batch (its sums over the rows) before
    their product.

    Returns (each row's per-position partial outputs, aux, the batch's
    routing: slots and keeps in the batch's group order)."""
    tok = [hs[0].shape[0] * hs[0].shape[1] for hs in hs_rows]
    dev0 = devs_rows[0][0]
    e = cfg.num_experts
    if not split:
        res = [_moe_row(p, hs, cfg, devs, group_size(cfg, t))
               for p, hs, devs, t in zip(p_rows, hs_rows, devs_rows, tok)]
        total, sums, rts = tok[0], res[0][1], [res[0][2]]
    else:
        total = sum(tok)
        g = group_size(cfg, total)
        if all(t % g == 0 for t in tok):
            res = [_moe_row(p, hs, cfg, devs, g)
                   for p, hs, devs in zip(p_rows, hs_rows, devs_rows)]
            sums = tuple(D.all_reduce([x[1][i] for x in res],
                                      [dev0] * len(res))[0]
                         for i in range(2))
            rts = [x[2] for x in res]
        else:
            res = []
            lo = 0
            gath = [D.all_gather([h[m] for h in hs_rows], 0,
                                 [devs[m] for devs in devs_rows])
                    for m in range(len(devs_rows[0]))]
            for r, (p, hs, devs) in enumerate(zip(p_rows, hs_rows,
                                                  devs_rows)):
                whole = [gm[r] for gm in gath]
                outs, sm, rt = _moe_row(p, whole, cfg, devs, g)
                br = hs[0].shape[0]
                res.append(([y[lo:lo + br] for y in outs], sm, rt))
                lo += br
            sums, rts = res[0][1], [res[0][2]]
    me, pe = (x.to(dev0) / total for x in sums)
    aux = e * torch.sum(me * pe)
    routing = {k: D.all_gather([getattr(r, k) for r in rts], 0, [dev0])[0]
               for k in ("slot", "keep")}
    return [x[0] for x in res], aux, routing
