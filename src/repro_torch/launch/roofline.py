"""Roofline analysis of a dry-run cell, as the reference's
`repro/launch/roofline.py`, for the NVIDIA H100.

Three terms per (arch x shape x mesh), in seconds, each the per-device
count over the per-device rate:
    compute    = flops / PEAK_FLOPS
    memory     = bytes_accessed / HBM_BW
    collective = collective bytes / LINK_BW

The counts come from `launch.dryrun.run_cell`: the step run once on the
"meta" device under a dispatch mode that counts each aten op's flops
(`torch.utils.flop_counter`) and bytes, with every collective of
`distributed.sharding` recorded (`sharding.counting`). The dry-run
counts every layer (a cut depth extrapolated to the config's), so its
`scan_correction` is 1.0; `analyze` keeps the factor for a caller that
counts one loop body. MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference),
N the active parameters, is the cross-check, as in the reference.

The card: NVIDIA H100 80GB HBM3 SXM at 700 W, as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
it ("NVIDIA H100 80GB HBM3, 700.00 W"). Its data sheet's dense rates:
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3.

The link rate is chosen, not inherited. Within one 8-GPU node NVLink 4
gives each H100 450 GB/s a direction. The production mesh's axes are 16
wide (`launch.mesh`), so every axis spans two 8-GPU NVLink domains and
each collective's slowest hop leaves the node: over the InfiniBand NDR
port that a DGX H100 pairs with each GPU, 400 Gb/s = 50 GB/s a
direction. LINK_BW is that 50 GB/s; with all of an axis inside one node
the term would shrink by 9x.

The reference parses collective sizes out of XLA's HLO text (its
`_COLL_RE`, `_shape_bytes`); nothing in the port emits HLO, so
`collective_bytes` sums the records of `sharding.counting()` instead.
"""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_FLOPS = 989e12         # H100 SXM bf16 dense, tensor cores
HBM_BW = 3.35e12            # H100 SXM HBM3
LINK_BW = 50e9              # one 400 Gb/s NDR port a GPU, across nodes


def collective_bytes(records: Iterable, devices: int = 1) -> Dict:
    """Per-device collective bytes from `sharding.counting()` records.

    Each record is (kind, bytes of one position's result, positions that
    receive it), one per call of the controller. A real mesh runs one op
    of the per-device program on each of those positions, so the
    per-device sums are the records' totals over the mesh's `devices`
    positions: total_bytes = Σ bytes·positions / devices, per kind, and
    num_ops = Σ positions / devices (the reference's convention: ops of
    the per-device program, sized by their results)."""
    per_kind: Dict[str, float] = {}
    ops = 0
    for kind, nbytes, positions in records:
        per_kind[kind] = per_kind.get(kind, 0) + nbytes * positions
        ops += positions
    per_kind = {k: v / devices for k, v in per_kind.items()}
    return dict(total_bytes=sum(per_kind.values()), per_kind=per_kind,
                num_ops=ops / devices)


def model_flops(cfg, shape) -> float:
    """6·N·D for training (fwd+bwd), 2·N·D for inference; N = active."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch        # decode: one token


def analyze(cell: dict, cfg, shape, scan_correction: float = 1.0) -> dict:
    """Roofline terms for a dry-run cell (see launch.dryrun.run_cell).

    The cell's flops, bytes and collective bytes are per device, so each
    term divides by the per-device rate only. MODEL_FLOPS is global, so
    the ideal time divides by all devices."""
    chips = cell["devices"]
    flops = cell["flops"] * scan_correction          # per device
    hbm = cell["bytes_accessed"] * scan_correction   # per device
    coll = cell["collectives"]["total_bytes"] * scan_correction

    t_compute = flops / PEAK_FLOPS
    t_memory = hbm / HBM_BW
    t_coll = coll / LINK_BW
    terms = dict(compute=t_compute, memory=t_memory, collective=t_coll)
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    t_ideal = mf / (chips * PEAK_FLOPS)
    t_bound = max(terms.values())
    return dict(
        **{f"t_{k}": v for k, v in terms.items()},
        bottleneck=bottleneck,
        model_flops=mf,
        useful_flops_frac=(mf / (flops * chips)) if flops else 0.0,
        roofline_frac=min(1.0, t_ideal / t_bound) if t_bound else 0.0,
        scan_correction=scan_correction,
    )
