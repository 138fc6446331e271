"""Two-stage hierarchical Gaussian testing (paper §IV-B, Fig. 6), stream half.

Stage 1 — sub-tile (8×8) AABB test; Stage 2 — Mini-Tile CAT in the CTU,
only on Gaussians that passed Stage 1. On the survivor-stream dataflow
Stage 1 produces per-tile compacted depth-ordered (T, K) lists and the CTU
tests only entries of those lists, emitting per-entry (T, K, regions) masks:
O(T·K·16) memory, CAT work spent on survivors only.

Under `OverflowPolicy.SPILL` the CTU runs once per compacted pass. Counters
in `ADDITIVE_COUNTER_KEYS` are sums over list entries, so summing them
across passes gives the frame totals; the rest are scene-level.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.gaussians import Projected, classify_spiky
from repro_torch.core.culling import TileGrid
from repro_torch.core.cat import (SamplingMode, entry_cat_mask,
                                  leader_pixel_count)
from repro_torch.core.precision import PrecisionScheme, FULL_FP32

ADDITIVE_COUNTER_KEYS = frozenset({
    "ctu_pairs", "ctu_pairs_no_stage1", "ctu_prs",
    "dup_tile", "dup_subtile", "dup_minitile",
    "vru_pairs", "vru_pairs_tile_aabb",
})


class StreamHierarchyOut(NamedTuple):
    lists: torch.Tensor            # (T, K) int32 depth-ordered Gaussian ids
    valid: torch.Tensor            # (T, K) bool — slot occupied
    entry_sub_mask: torch.Tensor   # (T, K, subtiles_per_tile) Stage-1 bits
    entry_mini_mask: torch.Tensor  # (T, K, minitiles_per_tile) CAT, gated
    overflow: torch.Tensor         # () bool: some tile exceeded capacity
    counters: dict                 # 0-d tensors


def entry_subtile_mask(proj: Projected, grid: TileGrid, lists: torch.Tensor,
                       valid: torch.Tensor,
                       tile_origins: Optional[torch.Tensor] = None):
    """(T, K, subtiles_per_tile) bool: Stage-1 sub-tile AABB evaluated only
    on compacted entries."""
    device = lists.device
    if tile_origins is None:
        tile_origins = grid.tile_origins(device)
    local = grid.subtile_local_origins(device)                 # (Sp, 2)
    x0 = (tile_origins[:, 0:1] + local[None, :, 0])[:, None, :]  # (T, 1, Sp)
    y0 = (tile_origins[:, 1:2] + local[None, :, 1])[:, None, :]
    x1 = x0 + grid.subtile
    y1 = y0 + grid.subtile

    idx = lists.clamp_min(0).long()
    mean = proj.mean2d[idx]
    mx = mean[..., 0][:, :, None]                              # (T, K, 1)
    my = mean[..., 1][:, :, None]
    r = proj.radius[idx][:, :, None]
    hit = ((mx + r) > x0) & ((mx - r) < x1) \
        & ((my + r) > y0) & ((my - r) < y1)
    live = (valid & proj.in_frustum[idx])[:, :, None]
    return hit & live


def _prs_per_minitile(proj: Projected, mode: SamplingMode,
                      spiky_threshold: float) -> torch.Tensor:
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)
    one, half = torch.ones_like(proj.depth), torch.full_like(proj.depth, 0.5)
    if mode == SamplingMode.UNIFORM_DENSE:
        return one
    if mode == SamplingMode.UNIFORM_SPARSE:
        return half
    if mode == SamplingMode.SMOOTH_FOCUSED:
        return torch.where(spiky, half, one)
    return torch.where(spiky, one, half)


def stream_entry_counters(proj: Projected, grid: TileGrid,
                          lists: torch.Tensor, valid: torch.Tensor,
                          sub_hits: torch.Tensor, mini_hits: torch.Tensor,
                          mode: SamplingMode = SamplingMode.SMOOTH_FOCUSED,
                          spiky_threshold: float = 3.0) -> dict:
    """The stream CTU's workload counters from per-entry hit counts
    (sub_hits/mini_hits: (T, K) int sub-tile and mini-tile hits)."""
    idx = lists.clamp_min(0).long()
    f32 = torch.float32
    n_listed = valid.sum()
    ctu_pairs = sub_hits.sum()
    prs = _prs_per_minitile(proj, mode, spiky_threshold)
    ctu_prs = (sub_hits * prs[idx]).sum() * grid.minitiles_per_subtile
    mini = mini_hits.sum().to(f32)
    return dict(
        n_gaussians=torch.tensor(float(proj.depth.shape[0]),
                                 device=lists.device),
        n_frustum=proj.in_frustum.sum().to(f32),
        ctu_pairs=ctu_pairs.to(f32),
        # Without Stage 1 the CTU tests every sub-tile of every entry.
        ctu_pairs_no_stage1=(n_listed * grid.subtiles_per_tile).to(f32),
        ctu_prs=ctu_prs.to(f32),
        leader_tests_per_pair=leader_pixel_count(proj, grid, mode,
                                                 spiky_threshold),
        dup_tile=n_listed.to(f32),
        dup_subtile=ctu_pairs.to(f32),
        dup_minitile=mini,
        vru_pairs=mini,
        vru_pairs_tile_aabb=(n_listed * grid.minitiles_per_tile).to(f32),
    )


def stream_entry_test(proj: Projected, grid: TileGrid, lists: torch.Tensor,
                      valid: torch.Tensor, overflow: torch.Tensor,
                      mode: SamplingMode = SamplingMode.SMOOTH_FOCUSED,
                      prec: PrecisionScheme = FULL_FP32,
                      spiky_threshold: float = 3.0, *,
                      cat_fn: Optional[Callable] = None) -> StreamHierarchyOut:
    """The CTU stage: per-entry Stage-1 sub-tile bits and Mini-Tile CAT on a
    compacted stream. cat_fn(proj, grid, lists, valid) -> (T, K, Mt) bool
    replaces the plain `cat.entry_cat_mask` (the CUDA CTU kernel)."""
    entry_sub = entry_subtile_mask(proj, grid, lists, valid)   # (T, K, Sp)
    if cat_fn is None:
        cat = entry_cat_mask(proj, grid, lists, valid, mode, prec,
                             spiky_threshold)
    else:
        cat = cat_fn(proj, grid, lists, valid)                 # (T, K, Mt)
    gate = entry_sub[:, :, grid.subtile_of_minitile_local(lists.device)]
    entry_mini = cat & gate & valid[:, :, None]
    sub_hits = entry_sub.sum(dim=-1)                           # (T, K)
    mini_hits = entry_mini.sum(dim=-1)
    counters = stream_entry_counters(proj, grid, lists, valid, sub_hits,
                                     mini_hits, mode, spiky_threshold)
    return StreamHierarchyOut(lists=lists, valid=valid,
                              entry_sub_mask=entry_sub,
                              entry_mini_mask=entry_mini,
                              overflow=overflow, counters=counters)
