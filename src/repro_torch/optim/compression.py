"""Gradient compression for the data-parallel all-reduce, as the
reference's `repro/optim/compression.py`.

Two schemes, both with error feedback (residual accumulation) so
compression error does not bias convergence:

  - top-k sparsification: keep the k largest-magnitude entries per tensor
    (modeled as a mask-multiply; the wire format on a real cluster is
    (indices, values)); the threshold is the k-th largest |g|, so ties
    with it are kept too, as in the reference.
  - int8 quantization: symmetric per-tensor scaling to int8, rounding half
    to even (`torch.round`, as `jnp.round`).

Used by `launch.train` under `--compress`.

Over a mesh a leaf is a `distributed.sharding.Sharded` (the residuals
are placed as the parameters). The reference compresses the whole,
logical gradient under any mesh; here each piece is compressed
elementwise with the whole leaf's constant (`leaf_constant`): top-k
keeps k = max(1, int(numel · topk_frac)) of the whole leaf, its
threshold the k-th largest |g| over the leaf's distinct blocks (each
replica group's block once: replicas would repeat values and lower it),
found from each block's own k largest (the whole leaf's k largest are
among them); int8's scale is the maximum over the blocks. A plain tensor
is the case of one block, so one code path serves both, and the result
equals, bit for bit, the one-device compression of the gathered
gradient; replicas stay equal. The threshold's candidates are an
all-gather and the scale's maxima an all-reduce (`sharding`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.distributed import sharding as D
from repro_torch.distributed.sharding import Sharded


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # none | topk | int8
    topk_frac: float = 0.01   # fraction of entries kept


def _zeros(p):
    if isinstance(p, Sharded):
        return p.map(_zeros)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_residuals(params):
    return unflatten(params, [_zeros(p) for p in flatten(params)])


def leaf_constant(blocks, numel: int, cfg: CompressionConfig, device,
                  positions: int = 1) -> torch.Tensor:
    """The constant of a leaf of `numel` entries held as its distinct
    `blocks` (each once): top-k's threshold, the k-th largest |g|, or
    int8's scale, max |g| / 127 + 1e-12; on `device`. `positions` is the
    number of mesh positions that a real mesh hands the constant's
    collective to."""
    flat = [torch.abs(b.reshape(-1)) for b in blocks]
    on = [device] * positions
    if cfg.kind == "topk":
        k = max(1, int(numel * cfg.topk_frac))
        cands = [torch.topk(b, min(k, b.numel())).values for b in flat]
        return torch.topk(D.all_gather(cands, 0, on)[0], k).values[-1]
    if cfg.kind == "int8":
        return D.all_reduce([torch.amax(b) for b in flat], on,
                            op=torch.maximum)[0] / 127.0 + 1e-12
    raise ValueError(cfg.kind)


def _apply_constant(g: torch.Tensor, c: torch.Tensor,
                   cfg: CompressionConfig) -> torch.Tensor:
    """What of `g` survives the wire under the leaf's constant `c`."""
    c = c.to(g.device)
    if cfg.kind == "topk":
        return g * (torch.abs(g) >= c).to(g.dtype)
    q = torch.clamp(torch.round(g / c), -127, 127).to(torch.int8)
    return q.float() * c


def _compress(gs: list, blocks: list, numel: int, cfg: CompressionConfig,
              device, positions: int) -> tuple:
    """(kept, residuals) of the pieces `gs` of one leaf (gradient plus
    residual, float32) whose distinct blocks are `blocks`."""
    if cfg.kind == "none":
        return gs, [torch.zeros_like(x) for x in gs]
    c = leaf_constant(blocks, numel, cfg, device, positions)
    hats = [_apply_constant(x, c, cfg) for x in gs]
    return hats, [x - h for x, h in zip(gs, hats)]


def compress_decompress(g, residual, cfg: CompressionConfig):
    """Returns (g_hat, new_residual): g_hat is what survives the wire."""
    g = g.float() + residual
    (hat,), (res,) = _compress([g], [g], g.numel(), cfg, g.device, 1)
    return hat, res


def _compress_sharded(g: Sharded, residual: Sharded,
                      cfg: CompressionConfig) -> tuple:
    """`compress_decompress` of a sharded leaf, piece by piece, with the
    whole leaf's constant (module docstring)."""
    sh = g.sharding
    gs = [x.float() + r for x, r in zip(g.pieces, residual.pieces)]
    hats, res = _compress(gs, [gs[grp[0]] for grp in sh.replica_groups()],
                          math.prod(g.shape), cfg, sh.mesh.primary,
                          sh.mesh.size)
    return Sharded(hats, sh), Sharded(res, sh)


def apply_tree(grads, residuals, cfg: CompressionConfig):
    out = [_compress_sharded(g, r, cfg) if isinstance(g, Sharded)
           else compress_decompress(g, r, cfg)
           for g, r in zip(flatten(grads), flatten(residuals))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
