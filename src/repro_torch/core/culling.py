"""Tile grid and the Stage-1 AABB intersection test."""
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

    def tile_origins(self, device="cpu") -> torch.Tensor:
        """(num_tiles, 2) int64 pixel (x, y) origins, row-major."""
        ys = torch.arange(self.tiles_y, device=device) * self.tile
        xs = torch.arange(self.tiles_x, device=device) * self.tile
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)

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


def aabb_mask(proj: Projected, origins: torch.Tensor, size: int):
    """Vanilla-3DGS axis-aligned bounding-box test: the Gaussian's square
    [mean - r, mean + r] against each size×size region. (R, N) bool."""
    mx, my = proj.mean2d[:, 0], proj.mean2d[:, 1]
    r = proj.radius
    x0 = origins[:, 0:1]                    # (R, 1)
    y0 = origins[:, 1:2]
    x1 = x0 + size
    y1 = y0 + size
    hit = ((mx + r)[None, :] > x0) & ((mx - r)[None, :] < x1) \
        & ((my + r)[None, :] > y0) & ((my - r)[None, :] < y1)
    return hit & proj.in_frustum[None, :]
