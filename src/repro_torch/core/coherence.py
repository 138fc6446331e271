"""Frame-coherent incremental rendering: reuse Stage-1 survivor streams.

On smooth camera paths consecutive frames can share Stage-1 survivors per
tile, so re-running the AABB test and the depth-ordered compaction from
scratch every frame repeats work. This module keeps the previous frame's
per-tile compacted lists in a `FrameCache` and, on the next camera,
recompacts only the tiles whose candidate set changed:

fingerprint
    For every in-frustum Gaussian the exact inclusive tile-index rectangle
    its AABB covers is derived float for float from the comparisons
    `culling.aabb_mask` evaluates (`tile_cover_rects`), so "tile t's
    candidate set" is exactly the set the fused compaction would build.
    Each tile's set is summarized in O(N + T) by a difference-array
    scatter and a 2D prefix sum of three lanes: two independent 32-bit id
    hashes (summed mod 2^32 over the members; they depend on the id only,
    so a set has one fingerprint from every viewpoint) and the exact
    member count. torch has no uint32 arithmetic on the CPU, so the hash
    lanes are built with numpy's wrapping uint32 and the sums run in
    int64, reduced mod 2^32 once at the end (exact: every partial sum
    stays below 2·N·2^32).

reuse
    A tile whose fingerprint is unchanged and whose count fits the plan's
    total capacity (k_max × passes) has the same member set as last frame,
    unclamped; its fresh compacted list would be exactly those members
    ordered by the new frame's global depth rank. So the cached row is
    re-sorted by rank (`_resort_rows`, a stable sort) instead of
    recompacted: no (tile, N) mask work. Tiles at or over capacity are
    always recompacted: the clamped prefix depends on the order, not just
    the set.

recompact
    The changed tiles, exactly those, run through the same
    `raster._compact_passes` chunked compaction as a full frame, over
    their gathered origins, and are scattered back into the cached rows.

fallback
    A camera jump past `CoherenceConfig.max_camera_jump`, a changed-tile
    fraction past `max_changed_frac`, a plan or scene swap, or a cold
    cache falls back to one full `stage1_compact` (counted as a
    `full_recompactions` frame: tiles_recompacted = T, tiles_reused = 0).

The contract: the incremental frame is bit-identical to a full
recompaction of the same frame (images, `entry_alive` and every workload
counter) across {CLAMP, SPILL} × {fused False, True}, because the
recompacted and re-sorted lists are equal as integer tensors and the CTU
and blend consume nothing else. The only probabilistic element is the
64-bit hash pair: two different member sets collide with probability
about 2^-64 per (tile, frame).

Host/device split: `render_incremental` runs the probe (projection and
fingerprint) on the scene's device, copies the (T, 3) fingerprints to the
host once, decides reuse there, then runs the incremental or the full
render. Every decision quantity lands on the active `obs.trace` tracer as
a `stage1_incremental` span.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import raster
from repro_torch.core.camera import Camera
from repro_torch.core.culling import TileGrid, aabb_mask
from repro_torch.core.gaussians import GaussianScene, Projected, project
from repro_torch.core.renderer import (ProjectedScene, RenderPlan,
                                       TileStream, enforce_overflow_policy)
from repro_torch.obs import trace as obs_trace

FINGERPRINT_LANES = 3      # hash lane A, hash lane B, exact member count
_U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CoherenceConfig:
    """Knobs of the incremental mode (thresholds are policy, not
    correctness: any decision produces bit-identical frames; the knobs
    only trade probe and recompaction work against reuse)."""
    max_changed_frac: float = 0.5   # above: full recompaction is cheaper
    max_camera_jump: float = 3.0    # ||ΔR||_F + ||Δposition||: a jump-cut
    # The reference pads the changed tiles to a power-of-two bucket of at
    # least this size to bound its compiled programs; the port has none to
    # bound and compacts exactly the changed tiles, so it reads no value.
    min_changed_bucket: int = 8


# ---------------------------------------------------------------------------
# Exact tile-cover rectangles (float for float against culling.aabb_mask)
# ---------------------------------------------------------------------------


def _last_lt(v: torch.Tensor, size: int) -> torch.Tensor:
    """Largest integer q with float32(q * size) < v, elementwise.

    float32 division is correctly rounded, so floor(v / size) is off by at
    most one from the answer; the ±1 candidates are then checked with the
    authoritative comparison, the expression `aabb_mask` evaluates (an
    integer origin promoted to float32)."""
    g = torch.clamp(torch.floor(v / size), -(2 ** 24), 2 ** 24).to(torch.int32)

    def lt(q):
        return (q * size).to(torch.float32) < v

    return torch.where(lt(g + 1), g + 1, torch.where(lt(g), g, g - 1))


def _first_gt(w: torch.Tensor, size: int) -> torch.Tensor:
    """Smallest integer p with float32(p * size) > w, elementwise."""
    g = torch.clamp(torch.floor(w / size), -(2 ** 24), 2 ** 24).to(torch.int32)

    def gt(p):
        return (p * size).to(torch.float32) > w

    return torch.where(gt(g), g, torch.where(gt(g + 1), g + 1, g + 2))


def tile_cover_rects(proj: Projected, grid: TileGrid):
    """Per-Gaussian inclusive tile-index rectangle of Stage-1 AABB hits.

    Returns (tx0, tx1, ty0, ty1, covered): int32 (N,) tensors clipped to
    the grid and a bool validity mask. Gaussian i hits tile (tx, ty) under
    `culling.aabb_mask(proj, grid.tile_origins(), grid.tile)` iff
    covered[i] and tx0 <= tx <= tx1 and ty0 <= ty <= ty1, exactly (the
    boundary comparisons are the same float32 expressions), which is what
    lets the fingerprint claim set equality.
    """
    t = grid.tile
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    # aabb_mask: hit_x(tx) = (mx + r > tx*t) & (mx - r < tx*t + t)
    tx_hi = _last_lt(mx + r, t)               # max tx with tx*t < mx + r
    tx_lo = _first_gt(mx - r, t) - 1          # min tx with (tx+1)*t > mx - r
    ty_hi = _last_lt(my + r, t)
    ty_lo = _first_gt(my - r, t) - 1
    covered = (proj.in_frustum
               & (tx_lo <= tx_hi) & (ty_lo <= ty_hi)
               & (tx_hi >= 0) & (tx_lo <= grid.tiles_x - 1)
               & (ty_hi >= 0) & (ty_lo <= grid.tiles_y - 1))
    tx0 = torch.clamp(tx_lo, 0, grid.tiles_x - 1)
    tx1 = torch.clamp(tx_hi, 0, grid.tiles_x - 1)
    ty0 = torch.clamp(ty_lo, 0, grid.tiles_y - 1)
    ty1 = torch.clamp(ty_hi, 0, grid.tiles_y - 1)
    return tx0, tx1, ty0, ty1, covered


@functools.lru_cache(maxsize=8)
def _hash_lanes_on(n: int, device: str) -> torch.Tensor:
    i = np.arange(1, n + 1, dtype=np.uint32)

    def mix(x):                        # numpy uint32 arrays wrap mod 2^32
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        return x ^ (x >> np.uint32(16))

    lanes = np.stack([mix(i), mix(i ^ np.uint32(0x9E3779B9))], axis=-1)
    return torch.from_numpy(lanes.astype(np.int64)).to(device)


def _id_hash_lanes(n: int, device="cpu") -> torch.Tensor:
    """(N, 2) int64 tensor holding per-Gaussian uint32 hashes: a function
    of the id only, so a tile's lane sums are camera-independent set
    summaries. Built once per (n, device) and shared: do not modify it."""
    return _hash_lanes_on(n, str(torch.device(device)))


def tile_fingerprints(proj: Projected, grid: TileGrid):
    """Per-tile candidate-set fingerprints, O(N + T).

    Returns (fp (T, 3) int64 holding uint32 values, counts (T,) int32).
    fp lanes 0..1 are the mod-2^32 sums of the member-id hashes, lane 2 the
    exact member count (the row sum of `aabb_mask`, and so the incremental
    path's exact overflow flag). Built as a 2D difference array: each
    Gaussian scatters ±h at the four corners of its tile-cover rect, and a
    double prefix sum recovers the per-tile sums. The scatter (`index_add_`,
    integer atomics on the card: deterministic) and the sums run in int64
    and are reduced mod 2^32 once, which equals uint32 wraparound
    arithmetic.
    """
    tx0, tx1, ty0, ty1, covered = tile_cover_rects(proj, grid)
    n = proj.mean2d.shape[0]
    device = proj.mean2d.device
    # Only covered Gaussians scatter (the others would add zeros, and all
    # pile onto the clipped corner cells).
    sel = torch.nonzero(covered).squeeze(1)
    w = torch.cat([_id_hash_lanes(n, device)[sel],
                   torch.ones((sel.shape[0], 1), dtype=torch.int64,
                              device=device)], dim=1)
    stride = grid.tiles_x + 1
    y0, y1 = ty0[sel].long() * stride, (ty1[sel].long() + 1) * stride
    x0, x1 = tx0[sel].long(), tx1[sel].long() + 1
    acc = torch.zeros(((grid.tiles_y + 1) * stride, FINGERPRINT_LANES),
                      dtype=torch.int64, device=device)
    acc.index_add_(0, torch.cat([y0 + x0, y0 + x1, y1 + x0, y1 + x1]),
                   torch.cat([w, -w, -w, w]))
    acc = acc.view(grid.tiles_y + 1, stride, FINGERPRINT_LANES)
    fp = torch.cumsum(torch.cumsum(acc, dim=0), dim=1)
    fp = fp[:grid.tiles_y, :grid.tiles_x].reshape(grid.num_tiles,
                                                  FINGERPRINT_LANES)
    fp = fp & _U32_MASK
    return fp, fp[:, 2].to(torch.int32)


# ---------------------------------------------------------------------------
# Reuse (re-sort cached rows by the new depth rank) + partial recompaction
# ---------------------------------------------------------------------------


def _resort_rows(proj: Projected, rows: torch.Tensor, valid: torch.Tensor,
                 order: torch.Tensor):
    """Re-sort cached per-tile id rows by the new frame's global depth rank.

    A tile with an unchanged, unclamped member set compacts to exactly its
    members ordered by position in `raster.depth_order`, so sorting the
    cached ids by the new rank (invalid slots keyed past every rank)
    reproduces the fresh list bit for bit, -1 padding included. The sort
    is stable, as the reference's: equal keys keep their slot order.
    order: the frame's `raster.depth_order(proj)`.
    """
    n = proj.mean2d.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=order.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=order.device)
    key = torch.where(valid, rank[rows.clamp(min=0).long()],
                      torch.full_like(rows, n))
    perm = torch.argsort(key, dim=-1, stable=True)
    return torch.gather(rows, -1, perm), torch.gather(valid, -1, perm)


def _recompact_changed(plan: RenderPlan, proj: Projected, grid: TileGrid,
                       rows: torch.Tensor, valid: torch.Tensor,
                       changed_ids: torch.Tensor, order: torch.Tensor):
    """Run Stage-1 compaction for the changed tiles only and scatter the
    results into the (re-sorted) cached rows, in place.

    changed_ids: (C,) int64 tile ids, exactly the changed tiles (the
    reference pads them to a power-of-two bucket for its compiled
    programs; torch indexing needs no padding). The compaction is the
    fused-AABB `raster._compact_passes` of a full frame, over the gathered
    tile origins and the Gaussians sorted by `order`, the frame's
    `raster.depth_order`.
    """
    c = changed_ids.shape[0]
    if c == 0:
        return rows, valid
    n = proj.mean2d.shape[0]
    k_max, passes = plan.stream.k_max, plan.n_passes
    by_depth = proj._replace(mean2d=proj.mean2d[order],
                             radius=proj.radius[order],
                             in_frustum=proj.in_frustum[order])
    origins = grid.tile_origins(changed_ids.device)[changed_ids]
    lists, vals, _ = raster._compact_passes(
        lambda ob: aabb_mask(by_depth, ob, grid.tile), origins, c, n,
        order, k_max, passes)
    rows[changed_ids] = lists.permute(1, 0, 2).reshape(c, passes * k_max)
    valid[changed_ids] = vals.permute(1, 0, 2).reshape(c, passes * k_max)
    return rows, valid


def _rows_to_streams(plan: RenderPlan, rows: torch.Tensor,
                     valid: torch.Tensor, overflow: torch.Tensor) -> tuple:
    """(T, passes*K) concatenated rows -> the per-pass TileStream tuple
    (inverse of the `_compact_passes` layout split)."""
    t = rows.shape[0]
    k_max, passes = plan.stream.k_max, plan.n_passes
    lists = rows.reshape(t, passes, k_max).permute(1, 0, 2).contiguous()
    vals = valid.reshape(t, passes, k_max).permute(1, 0, 2).contiguous()
    return tuple(TileStream(lists[p], vals[p], overflow, index=p)
                 for p in range(passes))


def _streams_to_rows(streams) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate a frame's per-pass lists along K: the cacheable form."""
    return (torch.cat([ts.lists for ts in streams], dim=1),
            torch.cat([ts.valid for ts in streams], dim=1))


# ---------------------------------------------------------------------------
# The three programs: probe, full recompaction, incremental
# ---------------------------------------------------------------------------


def _probe(plan: RenderPlan, scene: GaussianScene, camera):
    return tile_fingerprints(project(scene, camera), plan.grid.make())


def _full(plan: RenderPlan, scene: GaussianScene, camera):
    """Full recompaction render that also returns what the cache needs
    (rows, fingerprints). The stage sequence and span tree of
    `RenderPlan.render_with_stats`, so the frame is the full-recompaction
    baseline itself, not a reimplementation of it."""
    tracer = obs_trace.current()
    with tracer.span("render") as root:
        if tracer.enabled:
            root.set(dataflow=plan.dataflow, incremental=False, traced=False)
        with tracer.span("preprocess"):
            ps = plan.preprocess(scene, camera)
            tracer.block(ps)
        with tracer.span("stage1_compact"):
            streams = plan.stage1_compact(ps)
            tracer.block(streams)
        fp, counts = tile_fingerprints(ps.proj, ps.grid)
        (out, counters), = plan._render_streams_frames([ps], [streams],
                                                       tracer, root)
    rows, valid = _streams_to_rows(streams)
    return out, counters, rows, valid, fp, counts


def _incr(plan: RenderPlan, scene: GaussianScene, camera,
          rows: torch.Tensor, valid: torch.Tensor,
          changed_ids: torch.Tensor, overflow: torch.Tensor):
    """Incremental render: re-sort the reused rows, recompact the changed
    tiles, run the shared CTU/blend tail."""
    tracer = obs_trace.current()
    with tracer.span("render") as root:
        if tracer.enabled:
            root.set(dataflow=plan.dataflow, incremental=True, traced=False)
        with tracer.span("preprocess"):
            ps: ProjectedScene = plan.preprocess(scene, camera)
            tracer.block(ps)
        with tracer.span("stage1_incremental"):
            order = raster.depth_order(ps.proj)
            rows2, valid2 = _resort_rows(ps.proj, rows, valid, order)
            rows2, valid2 = _recompact_changed(
                plan, ps.proj, ps.grid, rows2, valid2, changed_ids, order)
            streams = _rows_to_streams(plan, rows2, valid2, overflow)
            tracer.block(streams)
        (out, counters), = plan._render_streams_frames([ps], [streams],
                                                       tracer, root)
    return out, counters, rows2, valid2


# ---------------------------------------------------------------------------
# FrameCache + the host-side orchestrator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrameCache:
    """Previous-frame survivor streams + fingerprints for one (plan, scene)
    stream of frames. Mutated in place by `render_incremental`; treat as
    opaque. `plan`/`scene` double as the invalidation keys: a value-unequal
    plan (resolution, k_max, spill pass bucket, backend...) or a different
    scene object forces a full recompaction that re-seeds the cache."""
    plan: RenderPlan
    scene: GaussianScene
    camera: Camera
    rows: torch.Tensor        # (T, passes*k_max) int32, passes concat on K
    valid: torch.Tensor       # (T, passes*k_max) bool
    fp: np.ndarray            # (T, 3) int64 (uint32 values) fingerprints
    counts: np.ndarray        # (T,) int32 exact candidate counts
    frames: int = 0           # frames served through this cache
    tiles_reused: int = 0     # cumulative, == sum of per-frame counters
    tiles_recompacted: int = 0
    full_recompactions: int = 0


def camera_delta(a: Camera, b: Camera) -> float:
    """Scalar camera-motion metric: Frobenius distance of the rotations
    plus euclidean distance of the optical centers (world units). Smooth
    trajectories step well under 1; a jump-cut lands far past
    `CoherenceConfig.max_camera_jump`."""
    def host(x):
        return np.asarray(x.detach().cpu(), np.float64)

    ra, rb = host(a.R_wc), host(b.R_wc)
    ta, tb = host(a.t_wc), host(b.t_wc)
    pa, pb = -ra.T @ ta, -rb.T @ tb
    return float(np.linalg.norm(ra - rb) + np.linalg.norm(pa - pb))


def _coherence_counters(counters: dict, reused: int, recompacted: int,
                        full: bool, device) -> dict:
    counters = dict(counters)
    f32 = dict(dtype=torch.float32, device=device)
    counters["tiles_reused"] = torch.tensor(float(reused), **f32)
    counters["tiles_recompacted"] = torch.tensor(float(recompacted), **f32)
    counters["full_recompactions"] = torch.tensor(1.0 if full else 0.0,
                                                  **f32)
    return counters


def _fp_to_host(fp: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """One device->host copy of the (T, 3) fingerprints; the count lane is
    the counts."""
    fp_np = fp.cpu().numpy()
    return fp_np, fp_np[:, 2].astype(np.int32)


def render_incremental(plan: RenderPlan, scene: GaussianScene, camera,
                       cache: Optional[FrameCache] = None,
                       cfg: Optional[CoherenceConfig] = None, *,
                       enforce: bool = True):
    """Render one frame, reusing the cache's survivor streams where the
    per-tile candidate sets are provably unchanged.

    Returns (RenderOut, counters, FrameCache): counters are the full
    render_with_stats set plus `tiles_reused` / `tiles_recompacted`
    (summing to the tile count every frame) and `full_recompactions`
    (1.0 on fallback and cold frames, else 0.0), 0-d float32 tensors on
    the frame's device. The returned cache is `cache` updated in place
    when it matched, else a fresh one.

    enforce: apply the plan's OverflowPolicy to the overflow flag (the
    serving engine passes False and applies it itself after its
    spill-retry loop).
    """
    if cfg is None:
        cfg = CoherenceConfig()
    grid = plan.grid.make()
    t = grid.num_tiles
    cap = plan.stream.k_max * plan.n_passes
    device = scene.means.device
    tracer = obs_trace.current()

    matched = (cache is not None and cache.plan == plan
               and cache.scene is scene)
    jump = camera_delta(cache.camera, camera) if matched else float("inf")

    with tracer.span("render_incremental",
                     {"height": grid.height, "width": grid.width}) as root:
        changed_idx = None
        fp_np = counts_np = None
        if matched and jump <= cfg.max_camera_jump:
            fp, _ = _probe(plan, scene, camera)
            fp_np, counts_np = _fp_to_host(fp)
            # Unchanged fingerprint (the count is a lane, so equal sets
            # only) AND within capacity: at or over cap the kept prefix
            # depends on the depth order, which the fingerprint ignores.
            changed = ((fp_np != cache.fp).any(axis=1)
                       | (counts_np > cap))
            changed_idx = np.nonzero(changed)[0]
            if len(changed_idx) > cfg.max_changed_frac * t:
                changed_idx = None            # cheaper to recompact fully

        full = changed_idx is None
        with tracer.span("stage1_incremental") as sp:
            if tracer.enabled:
                sp.set(full_recompaction=full, camera_jump=jump,
                       tiles=t,
                       tiles_recompacted=(t if full else len(changed_idx)),
                       tiles_reused=(0 if full else t - len(changed_idx)))
            if full:
                out, counters, rows, valid, fp, _ = _full(plan, scene,
                                                          camera)
                fp_np, counts_np = _fp_to_host(fp)
                reused, recompacted = 0, t
            else:
                overflow = torch.tensor(bool((counts_np > cap).any()),
                                        device=device)
                ids = torch.from_numpy(changed_idx).to(device)
                out, counters, rows, valid = _incr(
                    plan, scene, camera, cache.rows, cache.valid, ids,
                    overflow)
                reused, recompacted = t - len(changed_idx), len(changed_idx)

        counters = _coherence_counters(counters, reused, recompacted, full,
                                       device)
        if not matched:
            cache = FrameCache(plan=plan, scene=scene, camera=camera,
                               rows=rows, valid=valid, fp=fp_np,
                               counts=counts_np)
        else:
            cache.camera = camera
            cache.rows, cache.valid = rows, valid
            cache.fp, cache.counts = fp_np, counts_np
        cache.frames += 1
        cache.tiles_reused += reused
        cache.tiles_recompacted += recompacted
        cache.full_recompactions += int(full)
        if tracer.enabled:
            root.set(full_recompaction=full, tiles_reused=reused,
                     tiles_recompacted=recompacted)

    if enforce:
        enforce_overflow_policy(out.overflow, plan.stream.overflow,
                                k_max=plan.stream.k_max,
                                n_passes=plan.n_passes,
                                context="incremental frame")
    return out, counters, cache
