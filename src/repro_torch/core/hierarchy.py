"""Two-stage hierarchical Gaussian testing (paper §IV-B, Fig. 6).

Stage 1 — sub-tile (8×8) AABB test; Stage 2 — Mini-Tile CAT in the CTU,
only on Gaussians that passed Stage 1. Two dataflows realize it:

* the survivor stream (`stream_entry_test`, the default): Stage 1 produces
  per-tile compacted depth-ordered (T, K) lists and the CTU tests only
  entries of those lists, emitting per-entry (T, K, regions) masks:
  O(T·K·16) memory, CAT work spent on survivors only;
* the dense-mask oracle (`hierarchical_test`): the full (regions, N)
  boolean masks at every level, O(regions·N) memory, which every stream
  quantity must match. `baseline_masks` gives the AABB (vanilla 3DGS) and
  OBB (GSCore) baselines' masks in the same layout.

Both report the same workload counters; the dense ones are counted by
blocks of mask rows (`count_true`), never through a full-size integer copy
of a mask.

Under `OverflowPolicy.SPILL` the CTU runs once per compacted pass. Counters
in `ADDITIVE_COUNTER_KEYS` are sums over list entries, so summing them
across passes gives the frame totals; the rest are scene-level.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.gaussians import Projected, classify_spiky
from repro_torch.core.culling import TileGrid, aabb_mask, intersection_mask
from repro_torch.core.cat import (SamplingMode, entry_cat_mask,
                                  leader_pixel_count, minitile_cat_mask)
from repro_torch.core.precision import PrecisionScheme, FULL_FP32

ADDITIVE_COUNTER_KEYS = frozenset({
    "ctu_pairs", "ctu_pairs_no_stage1", "ctu_prs",
    "dup_tile", "dup_subtile", "dup_minitile",
    "vru_pairs", "vru_pairs_tile_aabb",
})


COUNT_CHUNK_ELEMS = 1 << 24   # mask elements per block when counting or
#                               gating a dense mask: a reduction of a bool
#                               tensor copies it to int64 first.


def _row_blocks(mask: torch.Tensor):
    """Row slices of a (R, N) mask of at most COUNT_CHUNK_ELEMS elements."""
    rows = max(1, COUNT_CHUNK_ELEMS // max(mask.shape[1], 1))
    return (slice(s, s + rows) for s in range(0, mask.shape[0], rows))


def count_true(mask: torch.Tensor) -> torch.Tensor:
    """() int64 number of set elements of a (R, N) bool mask."""
    total = torch.zeros((), dtype=torch.int64, device=mask.device)
    for rows in _row_blocks(mask):
        total += mask[rows].sum()
    return total


def count_true_per_column(mask: torch.Tensor) -> torch.Tensor:
    """(N,) int64 number of set rows in each column of a (R, N) mask."""
    total = torch.zeros(mask.shape[1], dtype=torch.int64, device=mask.device)
    for rows in _row_blocks(mask):
        total += mask[rows].sum(dim=0)
    return total


def exact_f32(x: torch.Tensor) -> torch.Tensor:
    """A sum of multiples of 1/2 taken in float64 (exact below 2**52 in any
    order) and rounded once to float32."""
    return x.to(torch.float64).sum().to(torch.float32)


class HierarchyOut(NamedTuple):
    tile_mask: torch.Tensor        # (num_tiles, N) any mini-tile in tile hit
    minitile_mask: torch.Tensor    # (num_minitiles, N) final CAT mask
    subtile_mask: torch.Tensor     # (num_subtiles, N) Stage-1 result
    counters: dict                 # 0-d tensors


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


def hierarchical_test(proj: Projected, grid: TileGrid,
                      mode: SamplingMode = SamplingMode.SMOOTH_FOCUSED,
                      prec: PrecisionScheme = FULL_FP32,
                      spiky_threshold: float = 3.0,
                      cat_mask: Optional[torch.Tensor] = None
                      ) -> HierarchyOut:
    """Stage-1 sub-tile AABB -> Stage-2 Mini-Tile CAT, as dense masks.

    cat_mask: optional precomputed (num_minitiles, N) bool CAT mask (the
    dense PRTU kernel's); computed with `cat.minitile_cat_mask` when None.
    It is gated by the Stage-1 bits in place and returned as
    `minitile_mask`: the caller hands it over.
    """
    device = proj.mean2d.device
    # Stage 1: sub-tile AABB (preprocessing core).
    sub_mask = aabb_mask(proj, grid.subtile_origins(device), grid.subtile)
    # Stage 2: Mini-Tile CAT gated by its sub-tile's Stage-1 bit, in place
    # by row blocks (no (M, N) gathered copy of the Stage-1 mask).
    mini_mask = (minitile_cat_mask(proj, grid, mode, prec, spiky_threshold)
                 if cat_mask is None else cat_mask)
    sub_of_mini = grid.subtile_of_minitile(device)                 # (M,)
    for rows in _row_blocks(mini_mask):
        mini_mask[rows] &= sub_mask[sub_of_mini[rows]]
    # Tile-level mask = OR over the tile's mini-tiles.
    tile_mask = grid.tile_or(mini_mask, grid.minitile)             # (T, N)

    # ---- workload counters ---------------------------------------------
    f32 = torch.float32
    ctu_pairs = count_true(sub_mask)
    # Without Stage 1 the CTU would test every sub-tile of every tile whose
    # tile-level AABB the Gaussian hits.
    tile_aabb = count_true(aabb_mask(proj, grid.tile_origins(device),
                                     grid.tile))
    prs = _prs_per_minitile(proj, mode, spiky_threshold)
    ctu_prs = exact_f32(count_true_per_column(sub_mask) * prs.double()) \
        * grid.minitiles_per_subtile
    mini = count_true(mini_mask).to(f32)
    counters = dict(
        n_gaussians=torch.tensor(float(proj.depth.shape[0]), device=device),
        n_frustum=proj.in_frustum.sum().to(f32),
        ctu_pairs=ctu_pairs.to(f32),
        ctu_pairs_no_stage1=(tile_aabb * grid.subtiles_per_tile).to(f32),
        ctu_prs=ctu_prs,
        leader_tests_per_pair=leader_pixel_count(proj, grid, mode,
                                                 spiky_threshold),
        dup_tile=tile_aabb.to(f32),
        dup_subtile=ctu_pairs.to(f32),
        dup_minitile=mini,
        # VRU workload: (mini-tile, Gaussian) pairs forwarded to the FIFOs.
        vru_pairs=mini,
        vru_pairs_tile_aabb=(tile_aabb * grid.minitiles_per_tile).to(f32),
    )
    return HierarchyOut(tile_mask=tile_mask, minitile_mask=mini_mask,
                        subtile_mask=sub_mask, counters=counters)


def baseline_masks(proj: Projected, grid: TileGrid, method: str):
    """Masks of the non-CAT baselines.

    "aabb" — vanilla 3DGS: tile-level AABB, every pixel blends the whole
             tile list (no mini-tile mask).
    "obb"  — GSCore: sub-tile OBB; pixels blend their sub-tile's list (a
             mini-tile mask constant over each sub-tile, so the sub-tile
             mask is returned and gathered per mini-tile at the entries:
             `raster.entry_mask_from_dense(..., size=grid.subtile)`).
    Returns (tile_mask (T, N), subtile_mask (S, N) or None, counters).
    """
    f32 = torch.float32
    if method == "aabb":
        tile_mask = intersection_mask(proj, grid, "aabb", "tile")
        n = count_true(tile_mask)
        return tile_mask, None, dict(
            dup_tile=n.to(f32),
            vru_pairs=(n * grid.minitiles_per_tile).to(f32))
    if method == "obb":
        sub = intersection_mask(proj, grid, "obb", "subtile")     # (S, N)
        n = count_true(sub)
        # A tile's mini-tiles cover exactly its sub-tiles, and each
        # sub-tile holds minitiles_per_subtile of them.
        return grid.tile_or(sub, grid.subtile), sub, dict(
            dup_subtile=n.to(f32),
            vru_pairs=(n * grid.minitiles_per_subtile).to(f32))
    raise ValueError(method)


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
    ctu_prs = exact_f32(sub_hits * prs.double()[idx]) \
        * grid.minitiles_per_subtile
    mini = mini_hits.sum().to(f32)
    return dict(
        n_gaussians=torch.tensor(float(proj.depth.shape[0]),
                                 device=lists.device),
        n_frustum=proj.in_frustum.sum().to(f32),
        ctu_pairs=ctu_pairs.to(f32),
        # Without Stage 1 the CTU tests every sub-tile of every entry.
        ctu_pairs_no_stage1=(n_listed * grid.subtiles_per_tile).to(f32),
        ctu_prs=ctu_prs,
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
