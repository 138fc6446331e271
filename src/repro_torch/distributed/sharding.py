"""Sharding rules: logical axis names -> mesh axes, over a mesh of torch
devices driven by one process.

Logical names, as the reference's rules (`repro/distributed/sharding.py`):
    "fsdp"  — parameter shards (ZeRO-3) over the intra-pod data axis:
              gathered at use, their gradients reduce-scattered. Over
              ("pod", "data") only under `fsdp_over_pod` on a mesh with a
              pod axis; otherwise pods hold replicas.
    "model" — the tensor-parallel axis (heads, the MLP hidden, the vocab).
    "sp"    — sequence shards of the residual stream and of the decode
              caches: the `model` axis.
    "tile"  — per-tile render work: the `model` axis, so frame x tile
              sharding composes on one mesh.
    "dp"    — the batch: every data axis of the mesh (pod and data).
    None    — replicated.

A `Mesh` is a (data, model) or (pod, data, model) array of
`torch.device`s. Devices may repeat: `Mesh([torch.device("cuda:0")] * 4)`
is four virtual shards on one card, and `[torch.device("cpu")] * 8` runs
every sharded path on the CPU.

A `NamedSharding` (`named`) is the mesh and the mesh axes of each
dimension. A dimension sharded over axes (a1, a2, ...) is cut into equal
contiguous blocks, one per index of those axes in mesh order, as jax cuts
it; a dimension they do not divide is refused. `shard` places a tensor as
one local piece per mesh position, on that position's device: positions
that replicate a block each hold their own copy, as separate cards
would. `gather` puts the pieces back together on the primary device, bit
for bit; `gather_over` does so over some axes only (the FSDP all-gather).
A `Sharded` pairs the pieces with their placement.

The collectives are differentiable tensor operations on the one
controller: all-gather is `.to(dev)` then `torch.cat`, all-reduce `.to`
then a sum, reduce-scatter a sum then a split. Autograd carries their
transposes: the gradient of a gathered shard is the sum of its uses.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch

AXIS_NAMES = (("data", "model"), ("pod", "data", "model"))


def _device(d) -> torch.device:
    """A torch.device with its index filled in where CUDA can name it, so
    that "cuda" and "cuda:0" are one device of the mesh."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _depth(x) -> int:
    return 1 + _depth(x[0]) if isinstance(x, (list, tuple)) and x else 0


def _nest(x, fn):
    if isinstance(x, (list, tuple)):
        return tuple(_nest(y, fn) for y in x)
    return fn(x)


def _dims(x) -> tuple:
    """The shape of a regular nested sequence; raises if it is ragged."""
    if not isinstance(x, tuple):
        return ()
    inner = {_dims(y) for y in x}
    if len(inner) != 1 or not x:
        lens = [len(y) if isinstance(y, tuple) else 0 for y in x]
        raise ValueError("mesh rows must be non-empty and of one length, "
                         f"got {lens}")
    return (len(x),) + inner.pop()


class Mesh:
    """An array of torch devices with named axes.

    devices: nested sequences of the axis names' rank. A lower rank gets
    leading axes of size 1: a flat sequence is one data row (shape
    (1, len)), a sequence of rows is (rows, len(row)).
    axis_names: ("data", "model") (the default) or ("pod", "data",
    "model"). `shape` maps each axis name to its size, as a jax Mesh's
    does."""

    def __init__(self, devices: Sequence, axis_names=None):
        names = tuple(axis_names or AXIS_NAMES[0])
        if names not in AXIS_NAMES:
            raise ValueError(f"mesh axes {names} are not one of "
                             f"{AXIS_NAMES}")
        devices = list(devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        depth = _depth(devices)
        if depth > len(names):
            raise ValueError(f"a device array of rank {depth} for the "
                             f"{len(names)} axes {names}")
        for _ in range(len(names) - max(depth, 1)):
            devices = [devices]
        arr = _nest(devices, _device)
        dims = _dims(arr)
        self.devices = arr
        self.axis_names = names
        self.shape = dict(zip(names, dims))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def positions(self) -> list:
        """Every position's index tuple, in mesh (row-major) order."""
        return list(itertools.product(*(range(n)
                                        for n in self.shape.values())))

    def device_at(self, pos) -> torch.device:
        d = self.devices
        for i in pos:
            d = d[i]
        return d

    def flat_devices(self) -> list:
        """Each position's device, in mesh order."""
        return [self.device_at(p) for p in self.positions()]

    @property
    def primary(self) -> torch.device:
        """The first device: where a mesh-wide gather lands."""
        return self.device_at((0,) * len(self.axis_names))

    def rows(self) -> list:
        """The flat position indices of each data row (every data axis
        fixed), rows in mesh order, each row's positions along "model"."""
        m = self.shape["model"]
        return [list(range(r * m, (r + 1) * m))
                for r in range(self.size // m)]

    def row(self, d: int) -> "Mesh":
        """Data row d of a (data, model) mesh as a mesh of its own (shape
        (1, model))."""
        return Mesh([self.devices[d]])

    def distinct_devices(self) -> tuple:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.flat_devices()))

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def dp_axes(mesh: Mesh) -> tuple:
    """The mesh's data axes (the batch splits over all of them)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def resolve(logical, mesh: Mesh, fsdp_over_pod: bool = False) -> tuple:
    """Map a tuple of logical axis names to mesh axes, one entry per
    dimension (a jax PartitionSpec's entries): "fsdp" -> "data" (or
    ("pod", "data") under `fsdp_over_pod` on a mesh with a pod axis),
    "model"/"sp"/"tile" -> "model", "dp" -> the data axes, None -> None
    (replicated)."""
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        elif name == "fsdp":
            if fsdp_over_pod and "pod" in mesh.axis_names:
                out.append(("pod", "data"))
            else:
                out.append("data")
        elif name in ("model", "sp", "tile"):
            out.append("model")
        elif name == "dp":
            out.append(dp_axes(mesh))
        else:
            raise ValueError(f"unknown logical axis {name!r}")
    return tuple(out)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and the mesh axes of each dimension (`resolve`'s tuple)."""
    mesh: Mesh
    spec: tuple

    def counts(self) -> tuple:
        """How many blocks each dimension is cut into."""
        return tuple(math.prod(self.mesh.shape[a] for a in _axes(e))
                     for e in self.spec)

    def block(self, pos) -> tuple:
        """The block index of each dimension held at mesh position `pos`."""
        idx = dict(zip(self.mesh.axis_names, pos))
        out = []
        for e in self.spec:
            i = 0
            for a in _axes(e):
                i = i * self.mesh.shape[a] + idx[a]
            out.append(i)
        return tuple(out)

    def check(self, shape) -> None:
        """Raise ValueError unless `shape` fits: one entry per dimension,
        each sharded dimension divided by its axes' size."""
        if len(shape) != len(self.spec):
            raise ValueError(f"sharding {self.spec} has {len(self.spec)} "
                             f"entries for a tensor of shape {tuple(shape)}")
        for n, c, e in zip(shape, self.counts(), self.spec):
            if n % c:
                raise ValueError(
                    f"dimension of size {n} cannot be sharded over {e} "
                    f"({c} ways): {c} does not divide it (shape "
                    f"{tuple(shape)}, sharding {self.spec})")

    def local_shape(self, shape) -> tuple:
        self.check(shape)
        return tuple(n // c for n, c in zip(shape, self.counts()))

    def replica_groups(self) -> list:
        """Flat positions grouped by the block they hold, each group in
        mesh order, groups in the order of their first position."""
        groups: dict = {}
        for i, pos in enumerate(self.mesh.positions()):
            groups.setdefault(self.block(pos), []).append(i)
        return list(groups.values())


def named(mesh: Mesh, logical, fsdp_over_pod: bool = False) -> NamedSharding:
    return NamedSharding(mesh, resolve(logical, mesh, fsdp_over_pod))


def _slice(x, sharding: NamedSharding, pos):
    counts = sharding.counts()
    for d, (i, c) in enumerate(zip(sharding.block(pos), counts)):
        if c > 1:
            n = x.shape[d] // c
            x = x.narrow(d, i * n, n)
    return x


def shard(x: torch.Tensor, sharding: NamedSharding) -> list:
    """One local piece of `x` per mesh position, on that position's device
    (each its own copy)."""
    sharding.check(x.shape)
    mesh = sharding.mesh
    return [_slice(x, sharding, pos).to(mesh.device_at(pos), copy=True)
            for pos in mesh.positions()]


def _assemble(blocks: dict, counts: tuple, device, prefix=()):
    """Concatenate `blocks` (block tuple -> tensor) along every dimension
    whose count exceeds 1, in block order, on `device`."""
    d = len(prefix)
    if d == len(counts):
        return blocks[prefix].to(device)
    if counts[d] == 1:
        return _assemble(blocks, counts, device, prefix + (0,))
    return torch.cat([_assemble(blocks, counts, device, prefix + (i,))
                      for i in range(counts[d])], d)


def gather(pieces: Sequence, sharding: NamedSharding, device=None):
    """The whole tensor from its pieces, on `device` (default the mesh's
    primary device): each block read from the first position holding it."""
    mesh = sharding.mesh
    blocks: dict = {}
    for p, pos in zip(pieces, mesh.positions()):
        blocks.setdefault(sharding.block(pos), p)
    return _assemble(blocks, sharding.counts(),
                     mesh.primary if device is None else device)


def gathered_spec(sharding: NamedSharding, axes) -> tuple:
    """The spec once the mesh axes `axes` are gathered; a dimension that
    mixes gathered and kept axes is refused."""
    axes = set(axes)
    out = []
    for e in sharding.spec:
        ax = set(_axes(e))
        if ax & axes and not ax <= axes:
            raise ValueError(f"cannot gather {sorted(axes)} out of {e}")
        out.append(None if ax & axes else e)
    return tuple(out)


def gather_over(pieces: Sequence, sharding: NamedSharding, axes) -> list:
    """The all-gather over the mesh axes `axes`: for each position, its
    piece with the dimensions sharded over `axes` made whole (from the
    positions that differ from it only along `axes`), on its device.
    Positions on one device that gather the same blocks share the result."""
    mesh = sharding.mesh
    names = mesh.axis_names
    keep = [i for i, a in enumerate(names) if a not in set(axes)]
    spec = gathered_spec(sharding, axes)
    # The counts of the gathered dimensions only.
    counts = tuple(c if s is None and e is not None else 1
                   for c, s, e in zip(sharding.counts(), spec,
                                      sharding.spec))
    groups: dict = {}
    for p, pos in zip(pieces, mesh.positions()):
        key = tuple(pos[i] for i in keep)
        blk = tuple(b if c > 1 else 0
                    for b, c in zip(sharding.block(pos), counts))
        groups.setdefault(key, {}).setdefault(blk, p)
    out, made = [], {}
    for pos in mesh.positions():
        key = tuple(pos[i] for i in keep)
        dev = mesh.device_at(pos)
        if (key, dev) not in made:
            made[key, dev] = _assemble(groups[key], counts, dev)
        out.append(made[key, dev])
    return out


# --- collectives over one mesh axis ------------------------------------------
#
# `pieces[i]` lives on position i of the axis, `devices[i]` is its device.
# Each position's result is computed on its device, in axis order, so that
# every position holds the same bits; positions sharing a device share it.

def all_gather(pieces: Sequence, dim: int, devices: Sequence) -> list:
    made = {}
    for d in devices:
        if d not in made:
            made[d] = torch.cat([p.to(d) for p in pieces], dim)
    return [made[d] for d in devices]


def all_reduce(pieces: Sequence, devices: Sequence) -> list:
    made = {}
    for d in devices:
        if d not in made:
            s = pieces[0].to(d)
            for p in pieces[1:]:
                s = s + p.to(d)
            made[d] = s
    return [made[d] for d in devices]


def reduce_scatter(pieces: Sequence, dim: int, devices: Sequence) -> list:
    n = len(devices)
    out = []
    for i, d in enumerate(devices):
        parts = [p.chunk(n, dim)[i] for p in pieces]
        s = parts[0].to(d)
        for q in parts[1:]:
            s = s + q.to(d)
        out.append(s)
    return out


class Sharded:
    """A tensor over a mesh: its placement and one local piece per mesh
    position, in mesh order."""
    __slots__ = ("pieces", "sharding")

    def __init__(self, pieces: Sequence, sharding: NamedSharding):
        self.pieces = list(pieces)
        self.sharding = sharding

    @classmethod
    def of(cls, x: torch.Tensor, sharding: NamedSharding) -> "Sharded":
        return cls(shard(x, sharding), sharding)

    @property
    def shape(self) -> tuple:
        return tuple(n * c for n, c in zip(self.pieces[0].shape,
                                           self.sharding.counts()))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def gather(self, device=None) -> torch.Tensor:
        return gather(self.pieces, self.sharding, device)

    def map(self, fn) -> "Sharded":
        return Sharded([fn(p) for p in self.pieces], self.sharding)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec})")


def map_with(fn, tree, other):
    """`fn(leaf, o)` over the leaves of `tree`, `o` the part of `other` at
    the leaf's place (a jax `tree.map` over a tree and a prefix tree).
    Nodes are dicts (by key), NamedTuples, lists and tuples; a leaf is
    anything else, a `Sharded` included."""
    if isinstance(tree, dict):
        return {k: map_with(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with(fn, v, o)
                            for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def place(x, sharding: NamedSharding):
    """`x` placed by `sharding`: a `Sharded`, or for a 0-d tensor (an
    optimizer's step) the controller's own copy on the primary device."""
    if x.dim() == 0:
        return x.to(sharding.mesh.primary, copy=True)
    return Sharded.of(x, sharding)


def shard_tree(tree, shardings):
    """Every tensor leaf of `tree` placed (`place`) by the `NamedSharding`
    at its place in `shardings`."""
    return map_with(place, tree, shardings)


def gather_tree(tree, device=None):
    """Every `Sharded` leaf of `tree` gathered whole (on `device`, default
    its mesh's primary); other leaves as they are."""
    return map_with(lambda x, _: x.gather(device)
                    if isinstance(x, Sharded) else x, tree, tree)


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
