"""Tile grid and the intersection tests: AABB (vanilla 3DGS, Stage 1) and
OBB (GSCore).

Two layouts index regions. The image-global one orders size×size regions
row-major over the whole image (the dense (regions, N) masks); the
tile-local one orders them row-major within their tile (the per-entry
(T, K, regions_per_tile) stream masks). `global_region_ids` bridges them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gaussians import Projected


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Image tiling hierarchy: tile -> sub-tile -> mini-tile."""
    height: int
    width: int
    tile: int = 16
    subtile: int = 8
    minitile: int = 4

    def __post_init__(self):
        if self.height % self.tile or self.width % self.tile:
            raise ValueError(f"image {self.height}x{self.width} is not "
                             f"aligned to {self.tile}-px tiles")
        if self.tile % self.subtile or self.subtile % self.minitile:
            raise ValueError("tile/subtile/minitile sizes must nest")

    @property
    def tiles_x(self) -> int:
        return self.width // self.tile

    @property
    def tiles_y(self) -> int:
        return self.height // self.tile

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def subtiles_per_tile(self) -> int:
        return (self.tile // self.subtile) ** 2

    @property
    def minitiles_per_tile(self) -> int:
        return (self.tile // self.minitile) ** 2

    @property
    def minitiles_per_subtile(self) -> int:
        return (self.subtile // self.minitile) ** 2

    @property
    def num_subtiles(self) -> int:
        return self.num_tiles * self.subtiles_per_tile

    @property
    def num_minitiles(self) -> int:
        return self.num_tiles * self.minitiles_per_tile

    # --- image-global layout (row-major over the whole image) ---
    def region_origins(self, size: int, device="cpu") -> torch.Tensor:
        """(num_regions, 2) int64 pixel (x, y) origins of size×size
        regions, row-major over the whole image."""
        ys = torch.arange(self.height // size, device=device) * size
        xs = torch.arange(self.width // size, device=device) * size
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)

    def tile_origins(self, device="cpu") -> torch.Tensor:
        """(num_tiles, 2) int64 pixel (x, y) origins, row-major."""
        return self.region_origins(self.tile, device)

    def subtile_origins(self, device="cpu") -> torch.Tensor:
        return self.region_origins(self.subtile, device)

    def minitile_origins(self, device="cpu") -> torch.Tensor:
        return self.region_origins(self.minitile, device)

    def subtile_of_minitile(self, device="cpu") -> torch.Tensor:
        """(num_minitiles,) index of the sub-tile containing each mini-tile
        (both image row-major)."""
        origins = self.minitile_origins(device)
        sx = origins[:, 0] // self.subtile
        sy = origins[:, 1] // self.subtile
        return sy * (self.width // self.subtile) + sx

    def tile_of_region(self, size: int, device="cpu") -> torch.Tensor:
        """(num_regions,) index of the tile containing each size×size region
        (image row-major)."""
        origins = self.region_origins(size, device)
        return ((origins[:, 1] // self.tile) * self.tiles_x
                + origins[:, 0] // self.tile)

    def global_region_ids(self, size: int, device="cpu") -> torch.Tensor:
        """(num_tiles, regions_per_tile) image-global row-major index of each
        tile-local region: the bridge between dense (regions, N) masks and
        per-entry (T, K, regions_per_tile) stream masks."""
        t_orig = self.tile_origins(device)                     # (T, 2)
        local = self.local_region_origins(size, device)        # (R, 2)
        gx = (t_orig[:, None, 0] + local[None, :, 0]) // size
        gy = (t_orig[:, None, 1] + local[None, :, 1]) // size
        return gy * (self.width // size) + gx

    def global_minitile_ids(self, device="cpu") -> torch.Tensor:
        return self.global_region_ids(self.minitile, device)

    def global_subtile_ids(self, device="cpu") -> torch.Tensor:
        return self.global_region_ids(self.subtile, device)

    def tile_or(self, mask: torch.Tensor, size: int) -> torch.Tensor:
        """(num_tiles, N) OR of an image-global (num_regions, N) mask of
        size×size regions over each tile's regions. Rows are image
        row-major, so a tile's regions are an (r, r) window of a view."""
        r = self.tile // size
        n = mask.shape[1]
        grouped = mask.view(self.tiles_y, r, self.tiles_x, r, n)
        return grouped.any(dim=(1, 3)).reshape(self.num_tiles, n)

    # --- tile-local layout (row-major within the tile) ---

    def local_region_origins(self, size: int, device="cpu") -> torch.Tensor:
        """(regions_per_tile, 2) int64 offsets of size×size regions inside
        one tile, row-major within the tile."""
        r = torch.arange(self.tile // size, device=device) * size
        gy, gx = torch.meshgrid(r, r, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)

    def minitile_local_origins(self, device="cpu") -> torch.Tensor:
        return self.local_region_origins(self.minitile, device)

    def subtile_local_origins(self, device="cpu") -> torch.Tensor:
        return self.local_region_origins(self.subtile, device)

    def subtile_of_minitile_local(self, device="cpu") -> torch.Tensor:
        """(minitiles_per_tile,) tile-local subtile index of each tile-local
        minitile (both row-major within the tile)."""
        origins = self.minitile_local_origins(device)
        spt_x = self.tile // self.subtile
        return ((origins[:, 1] // self.subtile) * spt_x
                + origins[:, 0] // self.subtile)


def tile_divisor_chunk(t: int, per_tile_elems: int, limit: int) -> int:
    """Largest divisor of `t` whose chunk holds <= `limit` elements (min 1).
    Bounds the live working set of per-tile computations."""
    if t * per_tile_elems <= limit:
        return t
    best = 1
    for d in range(2, t + 1):
        if t % d == 0 and d * per_tile_elems <= limit:
            best = d
    return best


REGION_CHUNK_ELEMS = 1 << 27   # bound on (regions × Gaussians) pairs a
#                                region test evaluates at once: the tests
#                                fill an (R, N) mask by blocks of regions.
#                                Equal to the compaction's tile-chunk bound,
#                                so a Stage-1 chunk is never split again.


def _by_region_blocks(test, origins: torch.Tensor, n: int) -> torch.Tensor:
    """(R, N) bool filled one block of regions at a time: `test(block of
    origins)` -> (block, N). Region rows are independent, so blocking
    changes no bit; it bounds the float intermediates of a test at the
    size of one block."""
    r = origins.shape[0]
    block = max(1, REGION_CHUNK_ELEMS // max(n, 1))
    if block >= r:
        return test(origins)
    out = torch.empty((r, n), dtype=torch.bool, device=origins.device)
    for s in range(0, r, block):
        out[s:s + block] = test(origins[s:s + block])
    return out


def aabb_mask(proj: Projected, origins: torch.Tensor, size: int):
    """Vanilla-3DGS axis-aligned bounding-box test: the Gaussian's square
    [mean - r, mean + r] against each size×size region. (R, N) bool,
    evaluated by blocks of regions."""
    return _by_region_blocks(lambda o: _aabb_block(proj, o, size), origins,
                             proj.radius.shape[0])


def _aabb_block(proj: Projected, origins: torch.Tensor, size: int):
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    x0 = origins[:, 0:1]                    # (R, 1)
    y0 = origins[:, 1:2]
    x1 = x0 + size
    y1 = y0 + size
    hit = ((mx + r)[None, :] > x0) & ((mx - r)[None, :] < x1) \
        & ((my + r)[None, :] > y0) & ((my - r)[None, :] < y1)
    return hit & proj.in_frustum[None, :]


def obb_mask(proj: Projected, origins: torch.Tensor, size: int):
    """GSCore-style oriented-bounding-box test via the separating axis
    theorem: the 3σ box in the Gaussian's eigenbasis against each size×size
    region, separated iff one of the 4 face normals (2 of the region, 2 of
    the box) separates them. (R, N) bool, evaluated by blocks of regions
    (its (R, N, 2) float intermediates would not fit otherwise)."""
    return _by_region_blocks(lambda o: _obb_block(proj, o, size), origins,
                             proj.mean2d.shape[0])


def _obb_block(proj: Projected, origins: torch.Tensor, size: int):
    center = proj.mean2d                                   # (N, 2)
    e = proj.eigvecs                                       # (N, 2, 2) cols
    half = 3.0 * torch.sqrt(torch.clamp_min(proj.eigvals, 1e-12))  # (N, 2)
    rc = origins + size / 2.0                              # (R, 2)
    rh = size / 2.0
    d = rc[:, None, :] - center[None, :, :]                # (R, N, 2)

    def obb_radius(axis):                                  # axis (N, 2)
        return (half[:, 0] * torch.abs((axis * e[:, :, 0]).sum(-1))
                + half[:, 1] * torch.abs((axis * e[:, :, 1]).sum(-1)))

    ex = torch.zeros_like(center)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(center)
    ey[:, 1] = 1.0
    sep = torch.abs(d[..., 0]) > (rh + obb_radius(ex))[None, :]
    sep |= torch.abs(d[..., 1]) > (rh + obb_radius(ey))[None, :]
    ax_obb = e.transpose(-1, -2)                           # (N, 2, 2) rows
    for k in range(2):
        axis = ax_obb[:, k, :]                             # (N, 2)
        proj_d = torch.abs(d[..., 0] * axis[:, 0] + d[..., 1] * axis[:, 1])
        r_reg = rh * (torch.abs(axis[:, 0]) + torch.abs(axis[:, 1]))
        sep |= proj_d > (r_reg + half[:, k])[None, :]
    return ~sep & proj.in_frustum[None, :]


def intersection_mask(proj: Projected, grid: TileGrid, method: str,
                      level: str = "tile") -> torch.Tensor:
    """(num_regions, N) bool region test of `method` ("aabb" | "obb") at
    `level` ("tile" | "subtile" | "minitile"), image-global rows."""
    size = {"tile": grid.tile, "subtile": grid.subtile,
            "minitile": grid.minitile}[level]
    origins = grid.region_origins(size, proj.mean2d.device)
    if method == "aabb":
        return aabb_mask(proj, origins, size)
    if method == "obb":
        return obb_mask(proj, origins, size)
    raise ValueError(f"unknown intersection method {method!r}")
