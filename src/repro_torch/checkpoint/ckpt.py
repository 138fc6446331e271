"""Checkpointing with atomic commits and restart support.

Layout:  <dir>/step_<N>/
             manifest.json        — step, number of leaves, shapes, dtypes
             shard_0.npz          — the leaves as leaf_0, leaf_1, ...

Commit protocol: write to step_<N>.tmp, fsync the manifest, atomic rename —
a partially written checkpoint is never visible, so preemption mid-save is
safe (restart picks the previous complete step).

Leaves are numbered in the order `jax.tree.flatten` gives the reference's
trees: dataclass fields in declaration order, NamedTuple fields, list and
tuple items in order, dict values by sorted key; None holds no leaf. So a
checkpoint written by either package restores in the other, bf16 leaves
included (stored as their 16 bits, as the reference's are). A leaf
placed over a mesh (`distributed.sharding.Sharded`) is saved gathered,
and restored into a `Sharded` leaf of `tree_like` placed as that leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(children in leaf order, rebuild(children) -> node), or None for a
    leaf."""
    if tree is None:
        return [], lambda _: None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, n) for n in names],
                lambda c: dataclasses.replace(tree, **dict(zip(names, c))))
    if _is_namedtuple(tree):
        return list(tree), lambda c: type(tree)(*c)
    if isinstance(tree, (list, tuple)):
        return list(tree), lambda c: type(tree)(c)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([tree[k] for k in keys],
                lambda c: {k: c[keys.index(k)] for k in tree})
    return None


def flatten(tree) -> list:
    """The leaves of `tree` in the reference's `jax.tree.flatten` order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for child in node[0] for leaf in flatten(child)]


def unflatten(tree_like, leaves) -> object:
    """`tree_like`'s structure with its leaves replaced, in order, by
    `leaves`."""
    it = iter(leaves)

    def build(tree):
        node = _children(tree)
        if node is None:
            return next(it)
        children, rebuild = node
        return rebuild([build(c) for c in children])

    out = build(tree_like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


# numpy has no bfloat16: the reference's bf16 leaves (ml_dtypes arrays)
# reach an .npz as 2-byte void ("|V2") holding their bits, and the port
# writes its bf16 tensors' bits the same way.
_BF16_BITS = np.dtype("V2")


def _is_sharded(x) -> bool:
    # Imported here: `distributed` imports this module.
    from repro_torch.distributed.sharding import Sharded
    return isinstance(x, Sharded)


def _to_numpy(x) -> np.ndarray:
    if _is_sharded(x):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x, arr: np.ndarray) -> str:
    if getattr(x, "dtype", None) == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == _BF16_BITS or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, tree) -> str:
    leaves = flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    manifest = dict(step=step, num_leaves=len(leaves),
                    shapes=[list(a.shape) for a in arrays.values()],
                    dtypes=[_dtype_name(x, a) for x, a in
                            zip(leaves, arrays.values())])
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit
    return final


def _steps(ckpt_dir: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like):
    """Restore into the structure of `tree_like` (shapes must match). A
    tensor leaf of `tree_like` gets its loaded leaf on its own device and
    dtype; any other leaf gets the numpy array."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = flatten(tree_like)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"structure mismatch: the checkpoint holds "
                         f"{manifest['num_leaves']} leaves, the tree "
                         f"{len(leaves)}")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
    new = []
    for i, (old, arr) in enumerate(zip(leaves, loaded)):
        if tuple(np.shape(old)) != tuple(arr.shape):
            raise ValueError(f"leaf {i}: {tuple(np.shape(old))} vs "
                             f"{arr.shape}")
        if isinstance(old, torch.Tensor):
            arr = _to_tensor(arr, old)
        elif _is_sharded(old):
            arr = type(old).of(_to_tensor(arr, old.pieces[0]), old.sharding)
        new.append(arr)
    return unflatten(tree_like, new)


def prune_old(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
