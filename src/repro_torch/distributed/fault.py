"""Fault tolerance: checkpoint/restart for training, the serving side and
the host side.

  FaultManager               — checkpoint/restart orchestration: periodic
                               saves (`checkpoint.ckpt`), a preemption-
                               signal hook, resume from the latest step.
  StragglerMonitor           — per-step wall-time ring buffer; flags steps
                               slower than median x threshold.
  ShardDropInjector          — chaos hook that marks tile shards as lost
                               for the next frame.
  render_with_shard_recovery — graceful degradation of a tile-sharded
                               render: if the injector reports a lost
                               shard, re-render exactly that shard's tiles
                               on the survivors
                               (`RenderPlan.render_tile_subset`) and splice
                               the rows back (`raster.retile`/`untile`)
                               under a bit-parity gate, so the frame
                               completes instead of failing.

  elastic_reshard            — re-place a host-resident (or gathered)
                               tree onto another mesh by its specs: the
                               elastic-scaling path after a node is lost
                               or gained (restore on the surviving
                               topology, re-shard, continue).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.distributed import sharding as D


@dataclasses.dataclass
class FaultConfig:
    # The reference's default is a fixed /tmp path; this one follows TMPDIR.
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    save_every: int = 50
    keep: int = 3
    install_sigterm_hook: bool = True


class FaultManager:
    """Owns the save/restore lifecycle of a training run."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._preempted = False
        if cfg.install_sigterm_hook:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass   # not in the main thread

    def _on_sigterm(self, signum, frame):
        # Preemption notice: request a final save at the next step
        # boundary instead of dying mid-step.
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def maybe_save(self, step: int, tree) -> Optional[str]:
        if self._preempted or step % self.cfg.save_every == 0:
            path = ckpt.save(self.cfg.ckpt_dir, step, tree)
            ckpt.prune_old(self.cfg.ckpt_dir, self.cfg.keep)
            return path
        return None

    def restore_latest(self, tree_like):
        """Returns (tree, step) — (tree_like, 0) when no checkpoint exists.
        A fit from one view replays no data, so resuming at step N repeats
        no step and skips none."""
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            return tree_like, 0
        return ckpt.restore(self.cfg.ckpt_dir, step, tree_like), step


class StragglerMonitor:
    """Flags a step whose wall exceeds `threshold` x the median of the last
    `window` steps, once at least 8 steps are in the window."""

    def __init__(self, window: int = 32, threshold: float = 1.5):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.flagged: list[tuple[int, float]] = []
        self._t0 = None
        self._step = 0

    def step_start(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def step_end(self) -> bool:
        dt = time.perf_counter() - self._t0
        is_straggler = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                self.flagged.append((self._step, dt))
                is_straggler = True
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@dataclasses.dataclass
class ShardDropInjector:
    """Chaos hook for tile-sharded serving: marks shards as lost.

    `take(n_shards)` is called by `render_with_shard_recovery` once per
    frame and returns the shard indices to treat as dead for that frame.
    With `once=True` (default) the drop fires on the first frame only: the
    node comes back (or is replaced) and later frames run healthy.
    """
    drop: tuple[int, ...] = ()
    once: bool = True
    drops_injected: int = 0

    def take(self, n_shards: int) -> tuple[int, ...]:
        if not self.drop or (self.once and self.drops_injected > 0):
            return ()
        bad = [s for s in self.drop if not 0 <= s < n_shards]
        if bad:
            raise ValueError(
                f"ShardDropInjector.drop {bad} out of range for "
                f"{n_shards} tile shards")
        self.drops_injected += 1
        return tuple(self.drop)


@dataclasses.dataclass(frozen=True)
class ShardRecoveryReport:
    dropped_shards: tuple[int, ...]
    tiles_recovered: int
    parity_ok: bool


def render_with_shard_recovery(plan, scene, camera, *, injector,
                               mesh=None):
    """Tile-sharded render with graceful degradation on shard loss.

    Renders the frame with `plan` (which must carry
    `ShardConfig(tile_shards > 1)`) under `mesh` (default: the active
    mesh), then asks `injector` whether any shard died. If so, each lost
    shard's contiguous tile block [s·T/S, (s+1)·T/S) is re-rendered on
    the frame's device through `plan.render_tile_subset` and spliced back
    into the frame. Tiles are independent and the row-wise CTU and blend
    are deterministic, so the recovered frame must equal the healthy one
    bit for bit; that parity gate is enforced here (RuntimeError on a
    mismatch: it would mean the renderer is nondeterministic, not that
    recovery roughly worked).

    Returns (RenderOut, counters dict, ShardRecoveryReport). The counters
    gain `shard_drops` and `tiles_recovered`.
    """
    from repro_torch.core import raster
    from repro_torch.distributed import sharding as dshard

    n_shards = plan.shard.tile_shards
    if n_shards <= 1:
        raise ValueError(
            "render_with_shard_recovery requires a tile-sharded plan "
            "(ShardConfig(tile_shards > 1)); got "
            f"tile_shards={n_shards}")
    mesh = mesh if mesh is not None else dshard.active_mesh()
    with dshard.use_mesh(mesh):
        healthy, counters = plan.render_with_stats(scene, camera)
    counters = dict(counters)
    device = healthy.image.device
    f32 = dict(dtype=torch.float32, device=device)
    dropped = injector.take(n_shards)
    if not dropped:
        counters["shard_drops"] = torch.tensor(0.0, **f32)
        counters["tiles_recovered"] = torch.tensor(0.0, **f32)
        return healthy, counters, ShardRecoveryReport((), 0, True)

    grid = plan.grid.make()
    per = grid.num_tiles // n_shards
    lost = torch.cat([torch.arange(s * per, (s + 1) * per, device=device)
                      for s in dropped])
    # The survivors re-run exactly the lost rows on one device:
    # preprocess and Stage 1 were never sharded.
    rows = plan.render_tile_subset(scene, camera, lost)

    def splice(field, new_rows):
        t = raster.retile(grid, field).clone()
        t[lost] = new_rows
        return raster.untile(grid, t)

    entry_alive = healthy.entry_alive.clone()
    entry_alive[lost] = rows["entry_alive"]
    recovered = raster.RenderOut(
        image=splice(healthy.image, rows["image"]),
        alpha=splice(healthy.alpha, rows["alpha"]),
        processed_per_pixel=splice(healthy.processed_per_pixel,
                                   rows["processed"]),
        blended_per_pixel=splice(healthy.blended_per_pixel,
                                 rows["blended"]),
        overflow=healthy.overflow,
        entry_alive=entry_alive,
    )
    bad = [name for name in ("image", "alpha", "processed_per_pixel",
                             "blended_per_pixel", "entry_alive")
           if not torch.equal(getattr(recovered, name),
                              getattr(healthy, name))]
    if bad:
        raise RuntimeError(
            "shard recovery parity gate failed: re-rendered tile rows "
            f"differ from the healthy frame on {bad} — the row-wise "
            "CTU/blend path is expected to be bit-deterministic")
    counters["shard_drops"] = torch.tensor(float(len(dropped)), **f32)
    counters["tiles_recovered"] = torch.tensor(float(lost.numel()), **f32)
    return recovered, counters, ShardRecoveryReport(
        tuple(dropped), int(lost.numel()), True)


def elastic_reshard(tree, target_mesh, spec_tree):
    """`tree` placed onto `target_mesh`: each tensor leaf (a `Sharded` one
    gathered first) becomes a `Sharded` by the spec at its place in
    `spec_tree` (mesh axes per dimension, as `models.pspec.
    partition_specs` gives them). A 0-d tensor (an optimizer's step) is
    the controller's: it goes to the mesh's primary device. Other leaves
    are kept."""
    def place(x, spec):
        if isinstance(x, D.Sharded):
            x = x.gather()
        if not isinstance(x, torch.Tensor):
            return x
        return D.place(x, D.NamedSharding(target_mesh, tuple(spec)))
    return D.map_with(place, tree, spec_tree)
