"""Frame-axis and tile-axis device sharding for serving batches.

A render batch is a batched `Camera` (a leading frame axis on every tensor
field). The engine splits that axis over the mesh's data axes
(`shard_frames`, per `distributed.sharding.dp_axes`) and replicates the
scene on every device (`replicate`); each data group then renders on its
row of the mesh, its tiles split over the row's `model` devices when the
plan is tile-sharded. On one card, a mesh of repeated devices gives the
same schedule with every shard on that card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.camera import Camera
from repro_torch.distributed.sharding import Mesh, dp_axes


def data_parallel_size(mesh: Mesh) -> int:
    """Number of ways the frame axis splits on `mesh`."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def tile_parallel_size(mesh: Mesh) -> int:
    """Number of ways the tile axis splits on `mesh` (the `model` axis)."""
    return mesh.shape.get("model", 1)


def tile_mesh(tile_shards: int, frame_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data=frame_shards, model=tile_shards) mesh.

    devices: the devices to lay out row-major (the first
    tile_shards x frame_shards are used); default every visible CUDA
    device. Devices may repeat: `[torch.device("cuda:0")] * 4` is four
    virtual shards on one card. Raises when there are too few."""
    need = tile_shards * frame_shards
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if need > len(devices):
        raise ValueError(
            f"tile_mesh needs {need} devices ({frame_shards} frame x "
            f"{tile_shards} tile) but only {len(devices)} are given or "
            "visible; pass devices=[...] (a device may repeat, e.g. "
            f"devices=[torch.device('cuda:0')] * {need} for virtual shards "
            "on one card)")
    return Mesh([devices[r * tile_shards:(r + 1) * tile_shards]
                 for r in range(frame_shards)])


def shard_frames(cameras: Camera, mesh: Mesh) -> list[Camera]:
    """Split a batched camera's frame axis over the mesh's data axes: one
    batched camera per data row, on that row's first device.

    A frame count that does not divide the data-parallel size is padded up
    to the next multiple by repeating the last frame; callers slice results
    back to the true frame count."""
    n_dp = data_parallel_size(mesh)
    pad = (-cameras.frames) % n_dp
    fields = ("R_wc", "t_wc", "fx", "fy", "cx", "cy")
    if pad:
        cameras = dataclasses.replace(cameras, **{
            f: torch.cat([getattr(cameras, f),
                          getattr(cameras, f)[-1:].expand(
                              pad, *getattr(cameras, f).shape[1:])])
            for f in fields})
    per = cameras.frames // n_dp
    return [dataclasses.replace(cameras, **{
        f: getattr(cameras, f)[d * per:(d + 1) * per] for f in fields}
    ).to(mesh.devices[d][0]) for d in range(n_dp)]


def replicate(tree, mesh: Mesh) -> dict:
    """One copy of `tree` (anything with `.to(device)`, e.g. a scene) per
    distinct device of the mesh, keyed by device; a device that already
    holds it keeps the same tensors."""
    return {d: tree.to(d) for d in mesh.distinct_devices()}
