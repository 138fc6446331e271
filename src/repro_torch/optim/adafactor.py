"""Adafactor (Shazeer & Stern, 2018) — factored second moments, as the
reference's `repro/optim/adafactor.py`.

For the largest models (arctic-480b) Adam's full m/v does not fit even
fully sharded; Adafactor's row/column-factored v with no first moment
cuts optimizer state from 2x params to ~params/d.

Elementwise work stays in the parameter's dtype (bf16 for arctic) and the
reductions accumulate in float32, as the reference writes them; every
scalar that enters a bf16 product is cast to bf16 first, as jax casts
it.

Over a mesh a parameter is `distributed.sharding.Sharded` and its moments
are placed by `launch.steps.adafactor_shardings`; its gradient comes with
its replicas summed (`adamw.sum_replicas`, as AdamW's). Each factored
mean (the row and column means of g², the row moment's mean, the
update's RMS) is its blocks' local sums, summed over the blocks that
split the dimension it runs over and divided by the global count; each
block is updated once, at its first holder, and copied to its replicas.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.distributed import sharding as D
from repro_torch.distributed.sharding import NamedSharding, Sharded
from repro_torch.optim.adamw import AdamWConfig, global_norm, lr_at


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 3e-4
    decay: float = 0.8          # \hat{beta2}_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128
    warmup_steps: int = 100
    total_steps: int = 10000


class FactoredMoment(NamedTuple):
    row: Any     # (..., d_row), or a () placeholder
    col: Any
    full: Any    # unfactored fallback for small/1D params


class AdafactorState(NamedTuple):
    v: Any       # tree of FactoredMoment
    step: torch.Tensor


def _should_factor(shape, cfg) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _leaves(tree) -> list:
    """The leaves of a params-shaped tree whose leaves may be
    FactoredMoments (kept whole)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _rebuild(tree, items: list):
    it = iter(items)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _moment_sharding(sh: NamedSharding, dims) -> NamedSharding:
    """A factored moment's placement: the parameter's mesh axes of the
    dimensions `dims` it keeps (as `launch.steps.adafactor_shardings`)."""
    return NamedSharding(sh.mesh, tuple(sh.spec[d] for d in dims))


def _zeros_sharded(shape, sh: NamedSharding) -> Sharded:
    local = sh.local_shape(shape)
    return Sharded([torch.zeros(local, dtype=torch.float32, device=d)
                    for d in sh.mesh.flat_devices()], sh)


def init(params, cfg: AdafactorConfig) -> AdafactorState:
    """Zero moments; a `Sharded` parameter's are placed as
    `launch.steps.adafactor_shardings` places them (a factored row and
    column over the parameter's axes of the dimensions they keep)."""
    def one(p):
        dev = p.sharding.mesh.primary if isinstance(p, Sharded) else p.device

        def zeros(shape, dims=None):
            if isinstance(p, Sharded) and dims is not None:
                return _zeros_sharded(shape, _moment_sharding(p.sharding,
                                                              dims))
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        n = len(p.shape)
        if _should_factor(p.shape, cfg):
            return FactoredMoment(
                row=zeros(p.shape[:-1], range(n - 1)),
                col=zeros(p.shape[:-2] + p.shape[-1:],
                          [*range(n - 2), n - 1]),
                full=zeros(()))
        return FactoredMoment(row=zeros(()), col=zeros(()),
                              full=zeros(p.shape, range(n)))

    first = flatten(params)[0]
    dev = first.sharding.mesh.primary if isinstance(first, Sharded) \
        else first.device
    return AdafactorState(v=_rebuild(params, [one(p) for p in
                                              _leaves(params)]),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=dev))


def apply(params, grads, state: AdafactorState, cfg: AdafactorConfig):
    """One Adafactor step. Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    t = step.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    lr = lr_at(step, AdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                                 total_steps=cfg.total_steps))
    gnorm = global_norm(grads)

    def upd(p, g, v: FactoredMoment):
        ct = p.dtype
        if _should_factor(p.shape, cfg):
            g2_row = torch.mean(torch.square(g.float()), dim=-1)
            g2_col = torch.mean(torch.square(g.float()), dim=-2)
            row = beta2 * v.row + (1 - beta2) * (g2_row + cfg.eps)
            col = beta2 * v.col + (1 - beta2) * (g2_col + cfg.eps)
            row_mean = torch.mean(row, dim=-1, keepdim=True)
            rfac = row / torch.clamp(row_mean, min=cfg.eps)
            denom = (torch.sqrt(torch.clamp(rfac, min=cfg.eps))[..., None]
                     * torch.sqrt(torch.clamp(col, min=cfg.eps))[..., None,
                                                                  :])
            u = g.to(ct) / denom.to(ct)
            new_v = FactoredMoment(row=row, col=col, full=v.full)
        else:
            g2 = torch.square(g.float()) + cfg.eps
            vhat = beta2 * v.full + (1 - beta2) * g2
            u = g.to(ct) / torch.sqrt(torch.clamp(vhat, min=cfg.eps)).to(ct)
            new_v = FactoredMoment(row=v.row, col=v.col, full=vhat)
        # Update clipping (RMS(u) <= clip_threshold), float32 reduce.
        rms_u = torch.sqrt(torch.mean(torch.square(u.float())) + 1e-30)
        scale = 1.0 / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        p_new = (p.to(ct) * (1 - lr * cfg.weight_decay).to(ct)
                 - (lr * scale).to(ct) * u)
        return p_new.to(p.dtype), new_v

    def upd_sharded(p: Sharded, g: Sharded, v: FactoredMoment):
        """`upd` over a parameter's distinct blocks: each mean is the sum
        of the blocks' local sums over the blocks that split its
        dimension, divided by the dimension's global size; each block is
        updated at its first holder and copied to its replicas."""
        sh = p.sharding
        poss = sh.mesh.positions()
        block = [sh.block(pos) for pos in poss]
        first = {}                           # block -> its first holder
        for grp in sh.replica_groups():
            first[block[grp[0]]] = grp[0]
        counts = sh.counts()
        n = len(p.shape)
        ct = p.dtype
        consts = {}

        def const(dev):
            if dev not in consts:
                consts[dev] = tuple(x.to(dev) for x in (beta2, lr))
            return consts[dev]

        def along(b, d) -> list:
            """The blocks that differ from `b` in dimension d only."""
            return [b[:d] + (j,) + b[d + 1:] for j in range(counts[d])]

        def total(parts, dev):
            return D.all_reduce(parts, [dev] * len(parts))[0]

        us, row, col, full = {}, {}, {}, {}
        if _should_factor(p.shape, cfg):
            sq = {b: torch.square(g.pieces[i].float())
                  for b, i in first.items()}
            rs = {b: torch.sum(x, dim=-1) for b, x in sq.items()}
            cs = {b: torch.sum(x, dim=-2) for b, x in sq.items()}
            for b, i in first.items():
                dev = p.pieces[i].device
                b2, _ = const(dev)
                rk, ck = b[:-1], b[:-2] + b[-1:]
                if rk not in row:
                    g2 = total([rs[x] for x in along(b, n - 1)], dev) \
                        / p.shape[-1]
                    row[rk] = b2 * v.row.pieces[i] + (1 - b2) * (g2
                                                                 + cfg.eps)
                if ck not in col:
                    g2 = total([cs[x] for x in along(b, n - 2)], dev) \
                        / p.shape[-2]
                    col[ck] = b2 * v.col.pieces[i] + (1 - b2) * (g2
                                                                 + cfg.eps)
            means = {}
            for b, i in first.items():
                dev = p.pieces[i].device
                if b[:-2] not in means:
                    means[b[:-2]] = total(
                        [torch.sum(row[x[:-1]], dim=-1, keepdim=True)
                         for x in along(b, n - 2)], dev) / p.shape[-2]
                rfac = row[b[:-1]] / torch.clamp(means[b[:-2]], min=cfg.eps)
                denom = (torch.sqrt(torch.clamp(rfac, min=cfg.eps))[..., None]
                         * torch.sqrt(torch.clamp(
                             col[b[:-2] + b[-1:]], min=cfg.eps))[..., None,
                                                                 :])
                us[b] = g.pieces[i].to(ct) / denom.to(ct)
        else:
            for b, i in first.items():
                b2, _ = const(p.pieces[i].device)
                g2 = torch.square(g.pieces[i].float()) + cfg.eps
                full[b] = b2 * v.full.pieces[i] + (1 - b2) * g2
                us[b] = g.pieces[i].to(ct) / torch.sqrt(
                    torch.clamp(full[b], min=cfg.eps)).to(ct)
        dev0 = sh.mesh.primary
        sq_u = total([torch.sum(torch.square(u.float())) for u in us.values()],
                     dev0)
        rms_u = torch.sqrt(sq_u / math.prod(p.shape) + 1e-30)
        scale = 1.0 / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        new = {}
        for b, i in first.items():
            dev = p.pieces[i].device
            _, r = const(dev)
            x = p.pieces[i]
            new[b] = (x.to(ct) * (1 - r * cfg.weight_decay).to(ct)
                      - (r * scale.to(dev)).to(ct) * us[b]).to(p.dtype)

        def placed(vals, key, like: Sharded) -> Sharded:
            """`vals` by block key, one piece a position of `like`'s
            placement: the first position of a key takes the tensor, the
            others a copy."""
            seen, out = set(), []
            for j, pj in enumerate(like.pieces):
                k = key(block[j])
                out.append(vals[k].to(pj.device, copy=k in seen))
                seen.add(k)
            return Sharded(out, like.sharding)

        new_p = placed(new, lambda b: b, p)
        if _should_factor(p.shape, cfg):
            new_v = FactoredMoment(
                row=placed(row, lambda b: b[:-1], v.row),
                col=placed(col, lambda b: b[:-2] + b[-1:], v.col),
                full=v.full)
        else:
            new_v = FactoredMoment(row=v.row, col=v.col,
                                   full=placed(full, lambda b: b, v.full))
        return new_p, new_v

    out = [upd_sharded(p, g, v) if isinstance(p, Sharded) else upd(p, g, v)
           for p, g, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state.v))]
    new_params = unflatten(params, [o[0] for o in out])
    new_v = _rebuild(params, [o[1] for o in out])
    return new_params, AdafactorState(new_v, step), dict(grad_norm=gnorm,
                                                         lr=lr)
