"""Mesh construction for the launch drivers.

`make_local_mesh` is the reference's one-device mesh with the production
axis names, over a torch device. `make_production_mesh` (16 × 16 and
2 × 16 × 16 TPU meshes) comes with the dry-runs of a later slice.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh


def make_local_mesh(device="cuda") -> Mesh:
    """A 1-device mesh shaped (data=1, model=1) over `device`."""
    return Mesh([device])
