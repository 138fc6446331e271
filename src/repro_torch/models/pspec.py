"""Parameter-spec trees: one declaration drives init and the parameter
layout, so their structure cannot drift apart.

A spec tree is a nested dict whose leaves are `PSpec`s. `init_params`
walks its leaves in sorted-key order (the order `jax.tree.flatten` gives
the reference's dicts) and draws each from one explicit
`torch.Generator`, with the reference's rules: "zeros", "ones", "small"
(normal × 0.02) and "fanin" (normal × fan_in**-0.5, fan_in the
second-to-last dimension). A float32 leaf is drawn in float32; a bf16
one (`param_dtype="bfloat16"`) in bf16, in place. The draws are not the
reference's jax random streams; weights are carried across packages with
`repro_torch.convert.lm_params_from_numpy`.

The logical axis names ("fsdp", "model", ...) on every spec give its
placement over a mesh (`shardings`, `partition_specs`), by the rules of
`distributed.sharding.resolve`; on one device they are unused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from repro_torch.distributed.sharding import NamedSharding, resolve


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor."""
    shape: Tuple[int, ...]
    logical: Tuple          # logical axis names, len == len(shape)
    init: str = "fanin"     # fanin | zeros | ones | small
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")


def leaves(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict, in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, path + ".")
        else:
            yield path, v


def tree_map(fn: Callable, tree):
    """`fn` applied to every leaf of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def stack(tree, n: int):
    """Prepend a stacked-layer dimension (the layer loop's leading axis)."""
    return tree_map(lambda p: PSpec((n,) + p.shape,
                                    (None,) + tuple(p.logical), p.init,
                                    p.dtype), tree)


def _init_one(p: PSpec, generator: Optional[torch.Generator], dtype=None,
              device=None) -> torch.Tensor:
    """One parameter by its spec's rule. On the "meta" device only the
    shape and dtype are made (no draw)."""
    dt = dtype or p.dtype
    device = torch.device(device if device is not None else "cpu")
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    if device.type == "meta":
        return torch.empty(p.shape, dtype=dt, device=device)
    fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
    scale = 0.02 if p.init == "small" else (1.0 / max(fan_in, 1)) ** 0.5
    gdev = generator.device if generator is not None else device
    if dt == torch.float32:
        x = torch.randn(p.shape, generator=generator, device=gdev) * scale
        return x.to(device=device)
    # A reduced-precision leaf is drawn in its own dtype, in place: drawn
    # in float32 first, deepseek's stacked experts (26 x 64 x 2048 x 2816)
    # would need two 38 GB temporaries.
    x = torch.empty(p.shape, dtype=dt, device=gdev)
    return x.normal_(generator=generator).mul_(scale).to(device)


def init_params(tree, generator: Optional[torch.Generator], dtype=None,
                device=None) -> dict:
    """A nested dict of tensors shaped like `tree`, its leaves drawn in
    sorted-key order from `generator` (on the generator's device, then
    moved to `device`)."""
    out: dict = {}
    for path, p in leaves(tree):
        node = out
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = _init_one(p, generator, dtype, device)
    return out


def shardings(tree, mesh, fsdp_over_pod: bool = False) -> dict:
    """A `NamedSharding` per spec of `tree`, on `mesh`."""
    return tree_map(lambda p: NamedSharding(
        mesh, resolve(p.logical, mesh, fsdp_over_pod)), tree)


def partition_specs(tree, mesh, fsdp_over_pod: bool = False) -> dict:
    """The mesh axes of each dimension (a PartitionSpec's entries) per
    spec of `tree`."""
    return tree_map(lambda p: resolve(p.logical, mesh, fsdp_over_pod), tree)
