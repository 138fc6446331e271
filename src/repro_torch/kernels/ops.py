"""Routing of the render pipeline through the kernels.

`core.renderer.RenderPlan` dispatches here for its "cuda" backends:
`TestConfig(backend="cuda")` routes the CTU's CAT through the PRTU kernels
(`entry_cat_mask_cuda` via `entry_cat_fn` on the stream dataflow, K1,
also chained after Stage 1 by `stream_hierarchical_test_cuda`;
`cat_mask_cuda` / `hierarchical_test_cuda` on the dense oracle, K4), and
`RasterConfig(fused=True)` routes the blend through the fused kernel
(`render_tiles_fused_passes`, K2). `blend_tiles_cuda` is the full-sweep
blend (K3), the unfused baseline the fused kernel is measured against.
Per-entry features are gathered in PyTorch (`gather_tile_features`); each
kernel wrapper takes its plain PyTorch version when the tensors lie on the
CPU.

A batch of B frames folds into the tile axis (`core.hierarchy.FrameFold`):
the operands of pass i of every frame are gathered from the frames'
concatenated `Projected` at offset list indices, each frame's tile
origins and pixel centres repeated, so K1 and K2 run once per pass for
the whole batch (`render_tiles_fused_frames`). Both kernels treat tiles
independently, so each frame's rows equal its own launch's. A tile shard
launches K2 on its block of rows (`blend_fused_rows`, tile origins that
need not start at 0) and the gathered rows finalize as one frame's
(`finalize_fused_frames`).
"""
from __future__ import annotations

import torch

from repro_torch.core.gaussians import Projected, classify_spiky
from repro_torch.core.culling import TileGrid
from repro_torch.core.cat import SamplingMode, leader_corners
from repro_torch.core.precision import PrecisionScheme
from repro_torch.core import hierarchy as H
from repro_torch.core import raster
from repro_torch.kernels import prtu, render as krender


def cat_mask_operands(proj: Projected, grid: TileGrid,
                      spiky_threshold: float = 3.0):
    """The dense PRTU kernel's operands: (p_top, p_bot) (M, 2) leader
    coords of every mini-tile, and mu, conic, lhs, spiky of every Gaussian.
    Culled Gaussians get lhs = -inf so they never pass."""
    device = proj.mean2d.device
    origins = grid.minitile_origins(device).to(torch.float32)
    m = float(grid.minitile - 1)
    lhs = torch.log(255.0 * torch.clamp_min(proj.opacity, 1e-12))
    lhs = torch.where(proj.in_frustum, lhs, torch.full_like(lhs,
                                                            float("-inf")))
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)
    return (origins + 0.5, origins + (m + 0.5), proj.mean2d.contiguous(),
            proj.conic.contiguous(), lhs, spiky.to(torch.int8))


def cat_mask_cuda(proj: Projected, grid: TileGrid, mode: SamplingMode,
                  prec: PrecisionScheme,
                  spiky_threshold: float = 3.0) -> torch.Tensor:
    """(num_minitiles, N) bool CAT mask via the dense PRTU kernel (rows
    are the grid's mini-tiles, image row-major)."""
    mask = prtu.prtu_cat_mask(
        *cat_mask_operands(proj, grid, spiky_threshold), mode=mode.value,
        coord_prec=prec.coord, delta_prec=prec.delta, mul_prec=prec.mul,
        acc_prec=prec.acc, slack=prec.slack,
        width=grid.width // grid.minitile)
    # The mask holds only 0 and 1: read it as bool without an (M, N) copy.
    return mask.view(torch.bool)


def hierarchical_test_cuda(proj: Projected, grid: TileGrid,
                           mode: SamplingMode, prec: PrecisionScheme,
                           spiky_threshold: float = 3.0) -> H.HierarchyOut:
    """`core.hierarchy.hierarchical_test` with the CAT from the dense PRTU
    kernel."""
    cat = cat_mask_cuda(proj, grid, mode, prec, spiky_threshold)
    return H.hierarchical_test(proj, grid, mode, prec, spiky_threshold,
                               cat_mask=cat)


def entry_cat_operands(proj: Projected, grid: TileGrid, lists, valid,
                       spiky_threshold: float = 3.0, tile_origins=None):
    """The PRTU kernel's operands gathered at the compacted lists:
    (p_top, p_bot, tile_origins, mu, conic, lhs, spiky). Invalid entries
    get lhs = -inf so the kernel rejects them. tile_origins: (T, 2) origin
    of each list row (the grid's tiles when None; a frame fold's
    otherwise)."""
    device = lists.device
    if tile_origins is None:
        tile_origins = grid.tile_origins(device)
    p_top, p_bot = leader_corners(grid, device)
    idx = lists.clamp_min(0).long()
    lhs = torch.log(255.0 * torch.clamp_min(proj.opacity, 1e-12))[idx]
    lhs = torch.where(valid & proj.in_frustum[idx], lhs,
                      torch.full_like(lhs, float("-inf")))
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)[idx]
    return (p_top, p_bot, tile_origins.to(torch.float32),
            proj.mean2d[idx], proj.conic[idx], lhs, spiky.to(torch.int8))


def entry_cat_mask_cuda(proj: Projected, grid: TileGrid, lists, valid,
                        mode: SamplingMode, prec: PrecisionScheme,
                        spiky_threshold: float = 3.0,
                        tile_origins=None) -> torch.Tensor:
    """(T, K, Mt) bool entry CAT mask via the entry-stream PRTU kernel;
    drop-in for `core.cat.entry_cat_mask`."""
    mask = prtu.prtu_entry_cat_mask(
        *entry_cat_operands(proj, grid, lists, valid, spiky_threshold,
                            tile_origins),
        mode=mode.value, coord_prec=prec.coord, delta_prec=prec.delta,
        mul_prec=prec.mul, acc_prec=prec.acc, slack=prec.slack)
    return mask != 0


def entry_cat_fn(mode: SamplingMode, prec: PrecisionScheme,
                 spiky_threshold: float = 3.0):
    """The `cat_fn` that `hierarchy.stream_entry_test` calls to route the
    entry CAT through the PRTU kernel."""
    return lambda p, g, ls, v, tile_origins=None: entry_cat_mask_cuda(
        p, g, ls, v, mode, prec, spiky_threshold, tile_origins)


def stream_hierarchical_test_cuda(proj: Projected, grid: TileGrid,
                                  mode: SamplingMode, prec: PrecisionScheme,
                                  spiky_threshold: float = 3.0, *,
                                  k_max: int,
                                  order=None) -> H.StreamHierarchyOut:
    """`core.hierarchy.stream_hierarchical_test` with the entry CAT on the
    entry PRTU kernel (K1, one launch)."""
    return H.stream_hierarchical_test(
        proj, grid, mode, prec, spiky_threshold, k_max=k_max, order=order,
        cat_fn=entry_cat_fn(mode, prec, spiky_threshold))


def gather_tile_features(proj: Projected, grid: TileGrid, lists, valid,
                         entry_mask=None, tile_origins=None):
    """Kernel operand blocks from compacted per-tile lists: (pix (T,P,2),
    feat (T,K,8), colors (T,K,3), valid_i8 (T,K), allow (T,K,Mt) int8).
    entry_mask: optional (T, K, Mt) per-entry CAT mask (None = all set).
    tile_origins: as in `entry_cat_operands`."""
    device = lists.device
    if tile_origins is None:
        tile_origins = grid.tile_origins(device)
    pix = raster.tile_pixels(grid, tile_origins)
    idx = lists.clamp_min(0).long()
    feat = torch.cat([
        proj.mean2d[idx],                                 # (T, K, 2)
        proj.conic[idx],                                  # (T, K, 3)
        proj.opacity[idx][..., None],                     # (T, K, 1)
        torch.zeros(lists.shape + (2,), dtype=torch.float32, device=device),
    ], dim=-1)
    colors = proj.color[idx]
    if entry_mask is None:
        allow = torch.ones(lists.shape + (grid.minitiles_per_tile,),
                           dtype=torch.int8, device=device)
    else:
        allow = entry_mask.to(torch.int8)
    return pix, feat, colors, valid.to(torch.int8), allow


def blend_tiles_cuda(proj: Projected, grid: TileGrid, lists, valid,
                     entry_mask=None):
    """Full-sweep blend of compacted lists through the K3 kernel: (rgb
    (T, P, 3), trans (T, P)), no termination, no background."""
    ops = gather_tile_features(proj, grid, lists, valid, entry_mask)
    return krender.blend_tiles(*ops)


def render_tiles_fused_passes(proj: Projected, grid: TileGrid, passes,
                              background: float = 0.0, overflow=False):
    """Fused-kernel blend over one or more compacted spill passes of one
    frame: `render_tiles_fused_frames` with a batch of one.

    passes: sequence of (lists (T, K), valid, entry_mask) — consecutive
    segments of each tile's depth-ordered survivor list. Returns
    (RenderOut, counters); see `render_tiles_fused_frames`.
    """
    (out, counters), = render_tiles_fused_frames(
        H.fold_frames([proj], grid), grid, [[p] for p in passes],
        background, [overflow])
    return out, counters


def render_tiles_fused_frames(fold: H.FrameFold, grid: TileGrid, passes,
                              background: float = 0.0, overflows=(False,)):
    """Fused-kernel blend of B frames, one K2 launch per spill pass.

    passes: per pass, one (lists (T, K), valid, entry_mask) per frame —
    consecutive segments of each tile's depth-ordered survivor list. The
    carried state (transmittance, RGB, counters) threads between the
    kernel calls via `init`, so the chain blends like one call over the
    concatenation when K is a multiple of K_BLK. A pass whose tiles have
    all terminated runs no chunk.

    Returns one (RenderOut, counters) per frame: the kernel-measured
    processed/blended/entry_alive (entry_alive concatenated over passes
    along K) and the sweep counters only the fused kernel reports:
    kblocks_processed, kblocks_total, swept_per_pixel.
    """
    state, alive_parts, kparts, kblocks_total = None, [], [], 0
    for frames in passes:
        lists, valid, masks = zip(*frames)
        fb = blend_fused_rows(fold, grid, fold.ids(lists), fold.cat(valid),
                              fold.cat(masks), state)
        state = (fb.trans, fb.rgb, fb.processed, fb.blended)
        alive_parts.append(fb.entry_alive)
        kparts.append(fb.kblocks_processed)
        kblocks_total += fb.kblocks_total
    return finalize_fused_frames(grid, fold.frames, state, background,
                                 overflows, alive_parts, kparts,
                                 kblocks_total)


def blend_fused_rows(fold: H.FrameFold, grid: TileGrid, ids, valid, masks,
                     state=None) -> krender.FusedBlendOut:
    """One K2 launch over the fold's rows: ids, valid, masks are the
    folded (B·t, K[, Mt]) operands of one pass, state the carried
    (trans, rgb, processed, blended) of the previous pass (None on the
    first)."""
    ops = gather_tile_features(fold.proj, grid, ids, valid, masks,
                               tile_origins=fold.tile_origins)
    return krender.blend_tiles_fused(*ops, init=state)


def finalize_fused_frames(grid: TileGrid, frames: int, state, background,
                          overflows, alive_parts, kparts, kblocks_total):
    """One (RenderOut, counters) per frame from the carried state of B
    frames' full rows (frame b's tiles at rows b·T..(b+1)·T-1), the
    per-pass entry_alive and the per-pass (B·T,) kblocks_processed."""
    device = state[0].device
    kproc = torch.zeros((frames,), dtype=torch.float32, device=device)
    for kp in kparts:
        kproc = kproc + kp.view(frames, grid.num_tiles).sum(dim=1).to(
            torch.float32)
    entry_alive = torch.cat(alive_parts, dim=1)
    outs = []
    t = grid.num_tiles
    for b in range(frames):
        rows = slice(b * t, (b + 1) * t)
        outs.append(finalize_fused_passes(
            grid, tuple(x[rows] for x in state), background, overflows[b],
            entry_alive[rows], kproc[b], kblocks_total))
    return outs


def finalize_fused_passes(grid: TileGrid, state, background, overflow,
                          entry_alive, kproc, kblocks_total):
    """(RenderOut, counters) from the fused kernel's carried state after
    the last pass. alpha = 1 - transmittance (the telescoping identity of
    the blend, exact up to the terminated tail)."""
    trans, rgb, processed, blended = state
    acc = 1.0 - trans
    rgb = rgb + background * trans[:, :, None]
    out = raster.RenderOut(
        image=raster.untile(grid, rgb),
        alpha=raster.untile(grid, acc),
        processed_per_pixel=raster.untile(grid, processed),
        blended_per_pixel=raster.untile(grid, blended),
        overflow=torch.as_tensor(overflow, device=rgb.device),
        entry_alive=entry_alive,
    )
    counters = dict(
        kblocks_processed=kproc,
        kblocks_total=torch.tensor(float(grid.num_tiles * kblocks_total),
                                   device=rgb.device),
        swept_per_pixel=kproc * krender.K_BLK / grid.num_tiles,
    )
    return out, counters
