"""Contribution-based pruning (paper §V-A, following "Trimming the Fat").

Ranks Gaussians by a global contribution score accumulated over a set of
views — the transmittance-weighted alpha mass each Gaussian deposits — and
removes the lowest-scoring fraction.

The scores double as the LOD stage's per-cluster contribution mass
(`repro_torch.lod.build_lod` accumulates them over probe cameras), so the
scoring loop is sized for multi-million-Gaussian scenes: Stage-1 lists come
from the fused, tile-chunked compaction (`raster.compact_aabb_tile_lists`,
no (T, N) mask materializes whole) and the per-tile weights are computed
over bounded tile chunks. Scores accumulate with the order-fixed
`clustering.segment_sum`, so they are the same bits on every run.
"""
from __future__ import annotations

import torch

from repro_torch.core import raster
from repro_torch.core.clustering import segment_sum
from repro_torch.core.culling import TileGrid, tile_chunk
from repro_torch.core.gaussians import GaussianScene, project

# Bound on tiles x pixels x (k_max * passes) float elements the per-tile
# weight computation holds live; larger problems loop over tile chunks.
CONTRIB_CHUNK_ELEMS = 1 << 24


def _tile_weights(proj, pix, lists, valid):
    """(B, passes, K) blend weights of B tiles' pass lists.

    pix (B, P, 2) pixel centers; lists, valid (passes, B, K). The per-pixel
    transmittance carries across the passes, so pass p's weights see the
    absorption of the first p*K survivors."""
    t_carry = torch.ones(pix.shape[:2], dtype=pix.dtype, device=pix.device)
    ws = []
    for lst, val in zip(lists, valid):
        idx = lst.clamp_min(0).long()                        # (B, K)
        g_mean, g_conic = proj.mean2d[idx], proj.conic[idx]
        g_op = proj.opacity[idx]
        d0 = pix[:, :, None, 0] - g_mean[:, None, :, 0]      # (B, P, K)
        d1 = pix[:, :, None, 1] - g_mean[:, None, :, 1]
        E = (0.5 * (g_conic[:, None, :, 0] * d0 ** 2
                    + g_conic[:, None, :, 2] * d1 ** 2)
             + g_conic[:, None, :, 1] * d0 * d1)
        a = torch.clamp_max(g_op[:, None, :] * torch.exp(-E),
                            raster.ALPHA_MAX)
        a = torch.where(val[:, None, :] & (a >= raster.ALPHA_MIN), a,
                        torch.zeros_like(a))
        T = torch.cumprod(1.0 - a, dim=2)
        T_excl = t_carry[:, :, None] * torch.cat(
            [torch.ones_like(T[..., :1]), T[..., :-1]], dim=2)
        ws.append(torch.sum(T_excl * a, dim=1))              # (B, K)
        t_carry = t_carry * T[..., -1]
    return torch.stack(ws, dim=1)                            # (B, passes, K)


def contribution_scores(scene: GaussianScene, cameras, grid: TileGrid,
                        k_max: int = 2048, passes: int = 1) -> torch.Tensor:
    """(N,) accumulated blending weight of each Gaussian over the cameras.

    Overflow-aware: survivors past a tile's `k_max` are not dropped —
    `passes` compacted lists per tile are scored, with the per-pixel
    transmittance carried across the passes. With `passes * k_max`
    covering the longest survivor list the scores equal a single unbounded
    compaction's (up to float association); a too-small total capacity only
    under-counts tail Gaussians, it never misattributes mass."""
    n = scene.n
    device = scene.means.device
    scores = torch.zeros((n,), dtype=torch.float32, device=device)
    poffs = raster._pixel_offsets(grid.tile, device)
    pixels = poffs.shape[0]
    origins = grid.tile_origins(device).to(torch.float32)
    t = grid.num_tiles
    chunk = tile_chunk(t, pixels * k_max * passes, CONTRIB_CHUNK_ELEMS)
    for cam in cameras:
        proj = project(scene, cam)
        order = raster.depth_order(proj)
        lists, valid, _ = raster.compact_aabb_tile_lists(
            proj, grid, order, k_max, passes)          # (passes, T, K)
        ws = torch.cat([
            _tile_weights(proj, origins[s:s + chunk, None, :] + poffs,
                          lists[:, s:s + chunk], valid[:, s:s + chunk])
            for s in range(0, t, chunk)])              # (T, passes, K)
        ids = lists.permute(1, 0, 2).reshape(-1)       # (T, passes, K) order
        keep = ids >= 0
        scores = segment_sum(ws.reshape(-1)[keep], ids[keep].long(), n,
                             init=scores)
    return scores


def prune(scene: GaussianScene, scores: torch.Tensor,
          keep_frac: float = 0.6) -> tuple[GaussianScene, torch.Tensor]:
    """Keep the top `keep_frac` Gaussians by score (ties in index order).
    Returns (scene, kept_idx). Changes N: an offline compression step."""
    n = scene.n
    k = max(1, int(n * keep_frac))
    idx = torch.argsort(-scores, stable=True)[:k]
    return GaussianScene(*(x[idx] for x in (
        scene.means, scene.log_scales, scene.quats, scene.opacity_logits,
        scene.colors))), idx
