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

Over a mesh the parameter tree's leaves are `distributed.sharding.Sharded`
and the moments are placed as their parameters (`launch.steps.
opt_shardings`). A `Sharded` gradient comes with each block summed over
the positions that replicate it (`sum_replicas`, which the train step
applies to each microbatch's gradient, as a data-parallel all-reduce
would: a replicated parameter's gradient is the sum of its uses);
`global_norm` counts each distinct block once; each block is updated
once and copied to its replicas, so that replicas stay bit-equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.distributed import sharding as D
from repro_torch.distributed.sharding import Sharded


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


def _zeros_like(p, dtype):
    if isinstance(p, Sharded):
        return p.map(lambda x: torch.zeros(x.shape, dtype=dtype,
                                           device=x.device))
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _device_of(p) -> torch.device:
    return p.sharding.mesh.primary if isinstance(p, Sharded) else p.device


def init(params, cfg: AdamWConfig) -> OptState:
    def zeros():
        return unflatten(params, [_zeros_like(p, cfg.moment_dtype)
                                  for p in flatten(params)])
    return OptState(m=zeros(), v=zeros(),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=_device_of(flatten(params)[0])))


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


def _blocks(x) -> list:
    """A leaf's distinct blocks: the tensor itself, or a `Sharded`'s piece
    at the first position of each replica group."""
    if isinstance(x, Sharded):
        return [x.pieces[g[0]] for g in x.sharding.replica_groups()]
    return [x]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's `jax.tree.leaves` order; a `Sharded` leaf's
    distinct blocks each once, in mesh order, on its primary device."""
    total = None
    for x in flatten(tree):
        n = x.sharding.mesh.size if isinstance(x, Sharded) else 1
        sq = D.all_reduce([torch.sum(torch.square(b.float()))
                           for b in _blocks(x)], [_device_of(x)] * n)[0]
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def sum_replicas(g: Sharded) -> Sharded:
    """Each block's gradient summed over the positions that hold it, in
    mesh order on each holder's device (once a device): the all-reduce of
    a data-parallel gradient."""
    out = list(g.pieces)
    for grp in g.sharding.replica_groups():
        s = D.all_reduce([g.pieces[i] for i in grp],
                         [g.pieces[i].device for i in grp])
        for i, x in zip(grp, s):
            out[i] = x
    return Sharded(out, g.sharding)


def apply(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    lr = lr_at(step, cfg)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    consts = {}

    def upd(p, g, m, v):
        # The step's scalars on the piece's device (the same tensors on
        # theirs).
        if p.device not in consts:
            consts[p.device] = tuple(x.to(p.device)
                                     for x in (scale, lr, bc1, bc2))
        sc, r, c1, c2 = consts[p.device]
        g = g.float() * sc
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        u = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        p_new = p.float() * (1 - r * cfg.weight_decay) - r * u
        return (p_new.to(p.dtype), m_new.to(cfg.moment_dtype),
                v_new.to(cfg.moment_dtype))

    def upd_sharded(p, g, m, v):
        """Each block updated at its first holder, copied to the rest."""
        outs = [[None] * len(p.pieces) for _ in range(3)]
        for grp in p.sharding.replica_groups():
            i = grp[0]
            dev = p.pieces[i].device
            res = upd(p.pieces[i], g.pieces[i], m.pieces[i], v.pieces[i])
            for j in grp:
                for o, r in zip(outs, res):
                    o[j] = r if j == i else r.to(p.pieces[j].device,
                                                 copy=True)
        return tuple(Sharded(o, p.sharding) for o in outs)

    out = [upd_sharded(*xs) if isinstance(xs[0], Sharded) else upd(*xs)
           for xs in zip(flatten(params), flatten(grads), flatten(state.m),
                         flatten(state.v))]
    new_params, new_m, new_v = (unflatten(params, [o[i] for o in out])
                                for i in range(3))
    metrics = dict(grad_norm=gnorm, lr=lr)
    return new_params, OptState(new_m, new_v, step), metrics
