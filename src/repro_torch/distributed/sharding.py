"""Sharding rules: logical axis names -> mesh axes, over a mesh of torch
devices driven by one process.

Logical names rendering uses:
    "tile" — per-tile render work. Resolves to the `model` mesh axis, so
             frame x tile sharding composes on one mesh: frames split over
             "data", each frame's tiles over "model".
    "dp"   — the frame batch: every data axis of the mesh.
    None   — replicated.

A `Mesh` is a (data, model) array of `torch.device`s. Devices may repeat:
`Mesh([torch.device("cuda:0")] * 4)` is four virtual tile shards on one
card, and `[torch.device("cpu")] * 4` runs every sharded path on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch


def _device(d) -> torch.device:
    """A torch.device with its index filled in where CUDA can name it, so
    that "cuda" and "cuda:0" are one device of the mesh."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (data, model) array of torch devices.

    devices: a flat sequence (one data row: shape (1, len)) or a sequence
    of equal-length rows (shape (rows, len(row))). `shape` maps each axis
    name to its size, as a jax Mesh's does."""
    axis_names = ("data", "model")

    def __init__(self, devices: Sequence):
        devices = list(devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        if not isinstance(devices[0], (list, tuple)):
            devices = [devices]
        rows = tuple(tuple(_device(d) for d in row) for row in devices)
        if len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("mesh rows must be non-empty and of one "
                             f"length, got {[len(r) for r in rows]}")
        self.devices = rows
        self.shape = {"data": len(rows), "model": len(rows[0])}

    @property
    def primary(self) -> torch.device:
        """The first device: where a mesh-wide gather lands."""
        return self.devices[0][0]

    def row(self, d: int) -> "Mesh":
        """Data row d as a mesh of its own (shape (1, model))."""
        return Mesh([self.devices[d]])

    def distinct_devices(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(d for r in self.devices for d in r))

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def dp_axes(mesh: Mesh) -> tuple:
    """The mesh's data axes (the frame batch splits over all of them)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def resolve(logical, mesh: Mesh) -> tuple:
    """Map a tuple of logical axis names to mesh axes: "tile" -> "model",
    "dp" -> the data axes, None -> None (replicated)."""
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        elif name == "tile":
            out.append("model")
        elif name == "dp":
            out.append(dp_axes(mesh))
        else:
            raise ValueError(f"unknown logical axis {name!r}")
    return tuple(out)


def on_device(device: torch.device):
    """Issue CUDA work on `device` for the duration (a no-op context off
    CUDA): the kernel wrappers launch on the current device's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# --- active mesh -----------------------------------------------------------
#
# Renderer internals are mesh-agnostic: a tile-sharded RenderPlan finds its
# mesh through this stack instead of carrying it in the plan. The serving
# engine pushes its mesh around every render; tests use `use_mesh(...)`.

_ACTIVE_MESHES: list[Mesh] = []


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh pushed by `use_mesh`, or None."""
    return _ACTIVE_MESHES[-1] if _ACTIVE_MESHES else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` discoverable via `active_mesh()` for the duration. A
    None mesh is a no-op, so callers can write `with use_mesh(self.mesh):`
    unconditionally."""
    if mesh is None:
        yield
        return
    _ACTIVE_MESHES.append(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESHES.pop()
