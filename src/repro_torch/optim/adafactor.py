"""Adafactor (Shazeer & Stern, 2018) — factored second moments, as the
reference's `repro/optim/adafactor.py`.

For the largest models (arctic-480b) Adam's full m/v does not fit even
fully sharded; Adafactor's row/column-factored v with no first moment
cuts optimizer state from 2x params to ~params/d.

Elementwise work stays in the parameter's dtype (bf16 for arctic) and the
reductions accumulate in float32, as the reference writes them; every
scalar that enters a bf16 product is cast to bf16 first, as jax casts
it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
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


def init(params, cfg: AdafactorConfig) -> AdafactorState:
    def one(p):
        def zeros(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _should_factor(p.shape, cfg):
            return FactoredMoment(row=zeros(p.shape[:-1]),
                                  col=zeros(p.shape[:-2] + p.shape[-1:]),
                                  full=zeros(()))
        return FactoredMoment(row=zeros(()), col=zeros(()),
                              full=zeros(p.shape))

    dev = flatten(params)[0].device
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

    out = [upd(p, g, v) for p, g, v in zip(
        _leaves(params), _leaves(grads), _leaves(state.v))]
    new_params = unflatten(params, [o[0] for o in out])
    new_v = _rebuild(params, [o[1] for o in out])
    return new_params, AdafactorState(new_v, step), dict(grad_norm=gnorm,
                                                         lr=lr)
