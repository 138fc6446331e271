"""Tile rasterizer: depth sort, per-tile list compaction, alpha blending.

Stage-1 tile masks are compacted into dense per-tile Gaussian lists in
depth order, so blending wastes no lanes on Gaussians no mini-tile of the
tile needs. Blending consumes the per-entry (T, K, minitiles_per_tile) CAT
masks of the survivor-stream dataflow; dense (num_minitiles, N) masks of
the oracle (and the OBB baseline's (num_subtiles, N) mask) convert via
`entry_mask_from_dense`.

All blending math matches vanilla 3DGS:
    alpha = min(0.99, o * exp(-E)),  skip if alpha < 1/255
    T_i = prod_{j<i} (1 - alpha_j),  c = sum_i T_i c_i alpha_i
`blend_pass` evaluates that recurrence as a strict front-to-back left fold
over list entries carrying a `BlendState`, which makes the blend
chunk-invariant: splitting a tile's list anywhere and resuming from the
carried state reproduces the single-sweep result bit for bit. That is what
`OverflowPolicy.SPILL` rides on. Early termination (T < T_EPS) is modeled
by the processed/blended counters here; the fused kernel
(`kernels.render.blend_tiles_fused`) performs it for real.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.gaussians import Projected, ALPHA_MIN
from repro_torch.core.culling import TileGrid, aabb_mask, tile_divisor_chunk

ALPHA_MAX = 0.99
T_EPS = 1e-4


class RenderOut(NamedTuple):
    image: torch.Tensor                # (H, W, 3)
    alpha: torch.Tensor                # (H, W) accumulated opacity
    processed_per_pixel: torch.Tensor  # (H, W) Gaussians the lane touched
    blended_per_pixel: torch.Tensor    # (H, W) Gaussians actually blended
    overflow: torch.Tensor             # () bool: a tile exceeded its capacity
    entry_alive: torch.Tensor          # (T, K) entry processed before the
    #                                    tile terminated (K spans all passes)


def depth_order(proj: Projected) -> torch.Tensor:
    """Global front-to-back order of Gaussians (culled ones pushed last).

    The sort must be stable: equal depths (and every culled Gaussian, keyed
    at +inf) keep their index order, as in the reference's argsort."""
    key = torch.where(proj.in_frustum, proj.depth,
                      torch.full_like(proj.depth, float("inf")))
    return torch.argsort(key.detach(), stable=True)


COMPACT_CHUNK_ELEMS = 1 << 27   # bound on T*N scan elements held live; larger
#                                 problems loop over tile chunks.


def _compact_block(mask_sorted: torch.Tensor, order: torch.Tensor,
                   k_max: int, passes: int = 1):
    """Compaction of one block of tiles (the (B, N) working set).

    mask_sorted: (B, N) Stage-1 mask whose column j is Gaussian order[j]
    (depth order). Survivor j of a tile lands in pass j // k_max, slot
    j % k_max. Returns lists (B, passes*k_max) int32 with the passes
    concatenated along the slot axis, valid (B, passes*k_max) bool,
    overflow () bool. Only the listed survivors are scattered (`nonzero`
    of the taken entries), not all B·N slots.
    """
    cap = passes * k_max
    rank = torch.cumsum(mask_sorted, dim=1, dtype=torch.int32)   # 1-based
    rows, cols = torch.nonzero(mask_sorted & (rank <= cap), as_tuple=True)
    lists = torch.full((mask_sorted.shape[0], cap), -1, dtype=torch.int32,
                       device=mask_sorted.device)
    lists[rows, rank[rows, cols].long() - 1] = order[cols].to(torch.int32)
    overflow = torch.any(rank[:, -1:] > cap)      # row totals: last rank
    return lists, lists >= 0, overflow


def _compact_passes(mask_of_block, block_operand: torch.Tensor, t: int,
                    n: int, order: torch.Tensor, k_max: int, passes: int):
    """Tile-chunk loop + pass-splitting layout for the compactions.

    mask_of_block(block_operand[chunk]) -> (chunk, N) bool Stage-1 mask in
    depth order. Returns (lists (passes, T, K), valid (passes, T, K),
    overflow ())."""
    chunk = tile_divisor_chunk(t, n, COMPACT_CHUNK_ELEMS)
    parts = [_compact_block(mask_of_block(block_operand[s:s + chunk]),
                            order, k_max, passes)
             for s in range(0, t, chunk)]
    lists = torch.cat([p[0] for p in parts])
    overflow = torch.stack([p[2] for p in parts]).any()
    lists = lists.reshape(t, passes, k_max).permute(1, 0, 2).contiguous()
    return lists, lists >= 0, overflow


def compact_tile_lists_passes(mask: torch.Tensor, order: torch.Tensor,
                              k_max: int, passes: int):
    """Multi-pass compaction of a (T, N) tile mask over unsorted Gaussian
    ids: survivors past a pass's k_max spill into the next pass's list.
    Returns (lists (passes, T, K) int32, valid (passes, T, K) bool,
    overflow ()), the passes concatenated along K equal to one
    `passes * k_max` compaction. Chunked over tiles; each chunk's columns
    are taken in depth order."""
    t, n = mask.shape
    return _compact_passes(lambda rows: rows[:, order], mask, t, n, order,
                           k_max, passes)


def compact_tile_lists(mask: torch.Tensor, order: torch.Tensor, k_max: int):
    """Per-tile Gaussian lists in depth order from a (T, N) tile mask:
    (lists (T, K) int32, valid (T, K) bool, overflow ())."""
    lists, valid, overflow = compact_tile_lists_passes(mask, order, k_max, 1)
    return lists[0], valid[0], overflow


def compact_aabb_tile_lists(proj: Projected, grid: TileGrid,
                            order: torch.Tensor, k_max: int,
                            passes: int = 1):
    """Stage-1 tile AABB test fused into the chunked compaction loop: the
    (T, N) mask only ever exists one tile chunk at a time, evaluated on the
    depth-sorted Gaussians so its columns are already in list order.
    Returns (lists (passes, T, K) int32, valid (passes, T, K) bool,
    overflow ()) where the passes concatenated along K equal one
    `passes * k_max` list."""
    device = proj.mean2d.device
    by_depth = proj._replace(mean2d=proj.mean2d[order],
                             radius=proj.radius[order],
                             in_frustum=proj.in_frustum[order])
    return _compact_passes(
        lambda origins: aabb_mask(by_depth, origins, grid.tile),
        grid.tile_origins(device), grid.num_tiles, proj.depth.shape[0],
        order, k_max, passes)


def untile(grid: TileGrid, x: torch.Tensor) -> torch.Tensor:
    """Per-tile pixel data (T, P, ...) -> image space (H, W, ...)."""
    c = x.shape[2:]
    x = x.reshape(grid.tiles_y, grid.tiles_x, grid.tile, grid.tile, *c)
    x = x.transpose(1, 2)  # (ty, tile, tx, tile, ...)
    return x.reshape(grid.height, grid.width, *c)


def _pixel_offsets(tile: int, device="cpu") -> torch.Tensor:
    """(P, 2) float32 pixel-center offsets, row-major within the tile."""
    r = torch.arange(tile, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return (torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)
            .to(torch.float32) + 0.5)


def _minitile_index_in_tile(grid: TileGrid, device="cpu") -> torch.Tensor:
    """(P,) index of each tile pixel's mini-tile, row-major within the tile."""
    t, m = grid.tile, grid.minitile
    r = torch.arange(t, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return ((dy // m) * (t // m) + (dx // m)).reshape(-1)


def entry_mask_from_dense(grid: TileGrid, mask: torch.Tensor,
                          lists: torch.Tensor,
                          size: Optional[int] = None) -> torch.Tensor:
    """Gather a dense image-global (num_regions, N) mask of size×size
    regions (mini-tiles by default) at compacted entries: (T, K,
    minitiles_per_tile) bool, each mini-tile reading the row of the region
    that holds it — the per-entry form the blend consumes (the bridge for
    the dense oracle and the OBB baseline's sub-tile mask). Invalid slots
    read Gaussian 0's bits; the blend gates them by `valid`."""
    size = grid.minitile if size is None else size
    device = lists.device
    cells = (grid.tile_origins(device)[:, None, :]
             + grid.minitile_local_origins(device)[None]) // size
    rows = cells[..., 1] * (grid.width // size) + cells[..., 0]  # (T, Mt)
    idx = lists.clamp_min(0).long()
    return mask[rows[:, None, :], idx[:, :, None]]            # (T, K, Mt)


def tile_pixels(grid: TileGrid, tile_origins: torch.Tensor) -> torch.Tensor:
    """(T, P, 2) float32 pixel centers of the tiles at `tile_origins`."""
    poffs = _pixel_offsets(grid.tile, tile_origins.device)
    return tile_origins.to(torch.float32)[:, None, :] + poffs[None, :, :]


class BlendState(NamedTuple):
    """Per-pixel blend accumulators carried across spill passes, tile-major
    (T, P[, ...]). Feeding a pass's output state into the next pass is
    bit-identical to blending the concatenated lists in one pass."""
    trans: torch.Tensor      # (T, P) carried transmittance (starts at 1)
    rgb: torch.Tensor        # (T, P, 3) accumulated color
    acc: torch.Tensor        # (T, P) accumulated alpha (sum of weights)
    processed: torch.Tensor  # (T, P) i32 entries touched while lane alive
    blended: torch.Tensor    # (T, P) i32 entries actually blended


def init_blend_state(num_tiles: int, pixels_per_tile: int,
                     device="cpu") -> BlendState:
    shape = (num_tiles, pixels_per_tile)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return BlendState(
        trans=torch.ones(shape, **f32), rgb=torch.zeros(shape + (3,), **f32),
        acc=torch.zeros(shape, **f32), processed=torch.zeros(shape, **i32),
        blended=torch.zeros(shape, **i32))


def entry_alpha(pix, mean_k, conic_k, op_k, lane):
    """One list entry's gated alpha at every pixel of every tile.

    pix (T, P, 2); mean_k (T, 2); conic_k (T, 3); op_k (T,); lane (T, P)
    bool (slot valid and the entry's mini-tile CAT bit set at the pixel).
    The operation order is the one every blend path of the port shares
    (and the CUDA blend kernel repeats): E = 0.5·(a·dx² + c·dy²) + b·dx·dy.
    """
    d0 = pix[..., 0] - mean_k[:, None, 0]                     # (T, P)
    d1 = pix[..., 1] - mean_k[:, None, 1]
    E = (0.5 * (conic_k[:, None, 0] * d0 ** 2 + conic_k[:, None, 2] * d1 ** 2)
         + conic_k[:, None, 1] * d0 * d1)
    a = torch.clamp_max(op_k[:, None] * torch.exp(-E), ALPHA_MAX)
    return torch.where(lane & (a >= ALPHA_MIN), a, torch.zeros_like(a))


def blend_pass(proj: Projected, grid: TileGrid, lists: torch.Tensor,
               valid: torch.Tensor, entry_mask: Optional[torch.Tensor],
               state: BlendState,
               tile_origins: Optional[torch.Tensor] = None):
    """Fold one compacted pass's entries into the blend state.

    entry_mask: optional (T, K, minitiles_per_tile) per-entry CAT mask —
    pixel p of tile t blends entry k only if entry_mask[t, k, m(p)]. None =
    every listed Gaussian is blended by every pixel of the tile.

    A strict left fold over the K entries, one (T, P) step at a time, so the
    per-step float-op sequence does not depend on where the list is split
    into passes. Returns (state', entry_alive (T, K) bool).
    """
    device = lists.device
    if tile_origins is None:
        tile_origins = grid.tile_origins(device)
    pix = tile_pixels(grid, tile_origins)                     # (T, P, 2)
    mt_in_tile = _minitile_index_in_tile(grid, device)        # (P,)
    idx = lists.clamp_min(0).long()
    mean, conic = proj.mean2d[idx], proj.conic[idx]           # (T, K, .)
    opac, col = proj.opacity[idx], proj.color[idx]
    trans, rgb, acc, proc, bl = state
    alive_seq = []
    for k in range(lists.shape[1]):
        lane = valid[:, k, None].expand(trans.shape)
        if entry_mask is not None:
            lane = lane & entry_mask[:, k][:, mt_in_tile]
        a = entry_alpha(pix, mean[:, k], conic[:, k], opac[:, k], lane)
        alive = trans >= T_EPS                                # (T, P)
        w = trans * a
        rgb = rgb + w[..., None] * col[:, k, None, :]
        acc = acc + w
        proc = proc + (lane & alive)
        bl = bl + ((a > 0) & alive)
        # Tile-level termination: entry k is processed iff any pixel of
        # the tile is still alive.
        alive_seq.append(alive.any(dim=1) & valid[:, k])
        trans = trans * (1.0 - a)
    entry_alive = (torch.stack(alive_seq, dim=1) if alive_seq else
                   torch.zeros(lists.shape, dtype=torch.bool, device=device))
    return BlendState(trans, rgb, acc, proc, bl), entry_alive


def finalize_blend(grid: TileGrid, state: BlendState, background: float,
                   overflow, entry_alive: torch.Tensor) -> RenderOut:
    """Apply the background against the final transmittance and assemble a
    `RenderOut` (once, after the last pass)."""
    rgb = state.rgb + background * (1.0 - state.acc)[..., None]
    return RenderOut(
        image=untile(grid, rgb), alpha=untile(grid, state.acc),
        processed_per_pixel=untile(grid, state.processed.to(torch.float32)),
        blended_per_pixel=untile(grid, state.blended.to(torch.float32)),
        overflow=torch.as_tensor(overflow, device=rgb.device),
        entry_alive=entry_alive,
    )


def render_reference(proj: Projected, grid: TileGrid,
                     background: float = 0.0) -> torch.Tensor:
    """Oracle renderer: every pixel blends every in-frustum Gaussian in
    exact depth order (no tiling, no tests). O(H·W·N) — tests only.
    Returns (H, W, 3)."""
    order = depth_order(proj)
    mean, conic = proj.mean2d[order], proj.conic[order]
    op = torch.where(proj.in_frustum[order], proj.opacity[order],
                     torch.zeros_like(proj.opacity[order]))
    col = proj.color[order]
    device = proj.mean2d.device
    xs = torch.arange(grid.width, dtype=torch.float32, device=device) + 0.5
    rows = []
    for yi in range(grid.height):
        y = yi + 0.5
        d_x = xs[:, None] - mean[None, :, 0]                     # (W, N)
        d_y = y - mean[None, :, 1]
        E = (0.5 * (conic[None, :, 0] * d_x ** 2
                    + conic[None, :, 2] * d_y ** 2)
             + conic[None, :, 1] * d_x * d_y)
        a = torch.clamp_max(op[None, :] * torch.exp(-E), ALPHA_MAX)
        a = torch.where(a >= ALPHA_MIN, a, torch.zeros_like(a))
        T = torch.cumprod(1.0 - a, dim=1)
        T_excl = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], dim=1)
        w = T_excl * a
        rows.append(w @ col + background * (1.0 - w.sum(dim=1))[:, None])
    return torch.stack(rows)                                     # (H, W, 3)
