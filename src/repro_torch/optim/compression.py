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
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"        # none | topk | int8
    topk_frac: float = 0.01   # fraction of entries kept


def init_residuals(params):
    return unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                              for p in flatten(params)])


def compress_decompress(g, residual, cfg: CompressionConfig):
    """Returns (g_hat, new_residual): g_hat is what survives the wire."""
    g = g.float() + residual
    if cfg.kind == "none":
        return g, torch.zeros_like(g)
    if cfg.kind == "topk":
        k = max(1, int(g.numel() * cfg.topk_frac))
        thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
        g_hat = g * (torch.abs(g) >= thresh).to(g.dtype)
        return g_hat, g - g_hat
    if cfg.kind == "int8":
        scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        g_hat = q.float() * scale
        return g_hat, g - g_hat
    raise ValueError(cfg.kind)


def apply_tree(grads, residuals, cfg: CompressionConfig):
    out = [compress_decompress(g, r, cfg)
           for g, r in zip(flatten(grads), flatten(residuals))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))
