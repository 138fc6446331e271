"""Mesh construction for the launch drivers, as the reference's
`repro/launch/mesh.py`.

Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2, data=16,
model=16), 512 devices; the pod axis is pure data parallelism (the
gradient sum crosses pods once a step; FSDP stays intra-pod unless a
config sets `fsdp_over_pod`). `make_local_mesh` is the one-device mesh
with the production axis names; `mesh_of` picks a driver's mesh from its
`--production-mesh` / `--multi-pod` flags (`add_mesh_args`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import AXIS_NAMES, Mesh


def production_shape(multi_pod: bool = False) -> tuple:
    return (2, 16, 16) if multi_pod else (16, 16)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh over `devices` (default every visible CUDA
    device), laid out row-major. An explicit list may repeat a device.
    Fewer devices than the mesh needs raise ValueError naming both
    counts, as `jax.make_mesh` does."""
    shape = production_shape(multi_pod)
    names = AXIS_NAMES[1] if multi_pod else AXIS_NAMES[0]
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh "
            f"{dict(zip(names, shape))} needs {need} devices; "
            f"{len(devices)} were given")
    flat = devices[:need]
    for n in reversed(shape[1:]):
        flat = [flat[i:i + n] for i in range(0, len(flat), n)]
    return Mesh(flat, names)


def mesh_of(args):
    """A driver's mesh: the production mesh under `--production-mesh` /
    `--multi-pod` (ValueError with the device count where there are too
    few), else None (one device)."""
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod)
    return None


def add_mesh_args(ap) -> None:
    """The drivers' `--production-mesh` and `--multi-pod` flags."""
    ap.add_argument("--production-mesh", action="store_true",
                    help="place the model on the 16 x 16 production mesh "
                    "of the visible CUDA devices")
    ap.add_argument("--multi-pod", action="store_true",
                    help="place it on the 2 x 16 x 16 multi-pod mesh")


def make_local_mesh(device="cuda") -> Mesh:
    """A 1-device mesh shaped (data=1, model=1) over `device`."""
    return Mesh([device])
