"""AdamW with production knobs, as the reference's `repro/optim/adamw.py`:
float32 (or bf16) moments shaped like the params, global-norm clipping,
decoupled weight decay, and optional gradient compression hooks (see
`optim.compression`).

Trees are nested dicts of tensors (`Model.params()`); `apply` is pure: it
returns new tensors and leaves its arguments as they were. The step's
scalars (`lr`, the bias corrections, the clip scale) are 0-d float32
tensors on the parameters' device, so they round as the reference's
float32 arrays do: a Python float enters each product cast to float32,
as jax casts a weak-typed scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32   # bf16 for the very largest models
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor      # () int32


def init(params, cfg: AdamWConfig) -> OptState:
    def zeros():
        return unflatten(params, [torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                              device=p.device)
                                  for p in flatten(params)])
    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=flatten(params)[0].device))


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay: a 0-d float32 tensor."""
    t = step.float()
    warm = t / max(cfg.warmup_steps, 1)
    frac = (t - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(t < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's `jax.tree.leaves` order."""
    total = None
    for x in flatten(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    lr = lr_at(step, cfg)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        p_new = p.float() * (1 - lr * cfg.weight_decay) - lr * u
        return (p_new.to(p.dtype), m_new.to(cfg.moment_dtype),
                v_new.to(cfg.moment_dtype))

    out = [upd(*xs) for xs in zip(flatten(params), flatten(grads),
                                  flatten(state.m), flatten(state.v))]
    new_params, new_m, new_v = (unflatten(params, [o[i] for o in out])
                                for i in range(3))
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_params, OptState(new_m, new_v, step), metrics
