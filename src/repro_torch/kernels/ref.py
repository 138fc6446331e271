"""Oracles for the kernels (shape for shape the reference's
`kernels/ref.py`): the dense CAT mask, the full-sweep blend, and the fused
blend's measured counters. Memory is O(M·N) or O(T·P·K): test oracles."""
from __future__ import annotations

import torch

from repro_torch.core.gaussians import ALPHA_MIN
from repro_torch.core.raster import ALPHA_MAX, T_EPS
# The dense CAT's oracle is its plain version: (M, G) int8, with the
# reference's default precision.
from repro_torch.kernels.prtu import \
    prtu_cat_mask_plain as prtu_cat_mask_ref  # noqa: F401
from repro_torch.kernels.render import K_BLK, pixel_minitile_index


def _allow_pixels(allow: torch.Tensor, p: int) -> torch.Tensor:
    """(T, K, Mt) int8 per-entry mask -> (T, P, K) bool per-pixel lanes."""
    mt_in_tile = pixel_minitile_index(p, allow.shape[2], allow.device)
    return allow[:, :, mt_in_tile].transpose(1, 2) != 0


def _alpha_lanes(pix, feat, valid, allow):
    """(T, P, K) gated alpha of every entry at every pixel, and the lanes."""
    px = pix[..., 0][:, :, None]                      # (T, P, 1)
    py = pix[..., 1][:, :, None]
    mx = feat[..., 0][:, None, :]                     # (T, 1, K)
    my = feat[..., 1][:, None, :]
    cxx = feat[..., 2][:, None, :]
    cxy = feat[..., 3][:, None, :]
    cyy = feat[..., 4][:, None, :]
    op = feat[..., 5][:, None, :]
    dx = px - mx
    dy = py - my
    e = 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy
    a = torch.clamp_max(op * torch.exp(-e), ALPHA_MAX)          # (T, P, K)
    lane = (valid[:, None, :] != 0) & _allow_pixels(allow, pix.shape[1])
    a = torch.where(lane & (a >= ALPHA_MIN), a, torch.zeros_like(a))
    return a, lane


def blend_tiles_ref(pix, feat, colors, valid, allow):
    """Oracle for `kernels.render.blend_tiles` (the full sweep, via
    cumprod). Returns (rgb (T, P, 3), trans (T, P))."""
    a, _ = _alpha_lanes(pix, feat, valid, allow)
    tcum = torch.cumprod(1.0 - a, dim=-1)
    t_excl = torch.cat([torch.ones_like(tcum[..., :1]), tcum[..., :-1]], -1)
    rgb = torch.einsum("tpk,tkc->tpc", t_excl * a, colors)
    return rgb, tcum[..., -1]


def blend_tiles_fused_ref(pix, feat, colors, valid, allow,
                          k_blk: int = K_BLK, t_eps: float = T_EPS):
    """The full (no-termination) sweep via cumprod, and what the fused
    kernel must report from it: processed/blended per pixel and entry_alive
    under the T >= t_eps rule, and the K blocks the kernel runs (block j of
    tile t runs iff j is below the tile's occupied-block bound and some
    pixel is still above t_eps entering it).

    Returns (rgb, trans, processed, blended, entry_alive, kblocks_processed,
    kblocks_total); rgb/trans are the full sweep, which the fused kernel
    matches to < t_eps. Memory is O(T·P·K) — a test oracle.
    """
    a, lane = _alpha_lanes(pix, feat, valid, allow)
    tcum = torch.cumprod(1.0 - a, dim=-1)
    t_excl = torch.cat([torch.ones_like(tcum[..., :1]), tcum[..., :-1]], -1)
    w = t_excl * a
    rgb = torch.einsum("tpk,tkc->tpc", w, colors)
    trans = tcum[..., -1]

    alive = t_excl >= t_eps                           # (T, P, K)
    processed = (lane & alive).to(torch.float32).sum(dim=-1)
    blended = ((a > 0) & alive).to(torch.float32).sum(dim=-1)
    entry_alive = alive.any(dim=1) & (valid != 0)     # (T, K)

    k = valid.shape[1]
    n_blocks = -(-k // k_blk)
    nvalid = (valid != 0).sum(dim=1)
    kb_bound = -(-nvalid // k_blk)                    # (T,)
    starts = torch.arange(n_blocks, device=pix.device) * k_blk
    t_enter = t_excl[:, :, starts]                    # (T, P, n_blocks)
    tile_alive = (t_enter >= t_eps).any(dim=1)        # (T, n_blocks)
    runs = tile_alive & (torch.arange(n_blocks, device=pix.device)[None, :]
                         < kb_bound[:, None])
    kblocks_processed = runs.to(torch.int32).sum(dim=1)
    return (rgb, trans, processed, blended, entry_alive, kblocks_processed,
            n_blocks)
