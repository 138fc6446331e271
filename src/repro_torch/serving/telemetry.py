"""Serving telemetry: rolling latency percentiles, throughput, and the
modeled-accelerator view of the traffic.

Every batch the engine renders is recorded with its wall-clock latency and
its per-frame FLICKER counters; `snapshot()` folds the rolling window into
p50/p95/p99 request latency, host frames/sec, and — through
`core.perfmodel` — the FPS the FLICKER ASIC would sustain on the same
per-frame workload (a model of the accelerator, not of the GPU that
rendered the frames).

A batch's counters reach the host in one device->host copy: the engine's
(B,) counter tensors are stacked and copied once (`host_counters`).

Every `record_batch` also publishes into a `repro_torch.obs.metrics`
registry (the process default unless one is passed in), so the rolling
window's process-wide complement — lifetime totals, latency histograms —
is scrapeable in Prometheus text format alongside the engine-level metrics
(`RenderEngine` publishes plan-cache size / misses / per-scene k_max into
the same registry).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

import torch

from repro_torch.core import perfmodel as pm
from repro_torch.obs import metrics as obs_metrics


def host_counters(counters: dict) -> dict:
    """{key: (B,) float64 numpy array} from per-frame counters: the tensors
    among them stacked and copied to the host in one transfer, anything
    else (numpy arrays, lists) converted where it is."""
    keys = [k for k, v in counters.items() if isinstance(v, torch.Tensor)]
    out = {k: np.asarray(v, np.float64) for k, v in counters.items()
           if k not in keys}
    if keys:
        stacked = torch.stack([counters[k].to(torch.float64).reshape(-1)
                               for k in keys]).cpu().numpy()
        out.update(zip(keys, stacked))
    return out


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    t_done: float            # perf_counter timestamp when the batch finished
    batch_size: int          # real frames (excluding bucket padding)
    bucket_size: int         # padded/compiled batch size
    latency_s: float         # wall-clock for the whole batch
    modeled_fps: float       # mean modeled accelerator FPS over the frames
    counters: dict           # per-frame counter means (python floats)
    overflow_frames: int = 0  # frames whose Stage-1 lists overflowed k_max
    spill_retries: int = 0    # SPILL re-renders after capacity exhaustion


class Telemetry:
    """Rolling window over the last `window` batches."""

    def __init__(self, window: int = 256, hw: pm.HwConfig = pm.FLICKER_HW,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.hw = hw
        self.registry = (registry if registry is not None
                         else obs_metrics.get_registry())
        self._records: collections.deque[BatchRecord] = \
            collections.deque(maxlen=window)
        self.total_frames = 0
        self.total_batches = 0
        self.total_overflow_frames = 0
        self.total_spill_retries = 0
        # Frame-coherence lifetime totals (incremental serving mode): summed
        # from the per-frame tiles_reused / tiles_recompacted /
        # full_recompactions counters whenever a batch carries them.
        self.total_tiles_reused = 0
        self.total_tiles_recompacted = 0
        self.total_full_recompactions = 0
        # Request-level accounting (scheduler traffic): lifetime totals and
        # a rolling per-tier latency window for snapshot percentiles.
        self.total_requests = 0
        self.total_deadline_misses = 0
        self.total_degraded = 0
        self.total_rejected = 0
        self._tier_window = window
        self._tier_lat: dict[str, collections.deque] = {}

    def record_batch(self, *, batch_size: int, bucket_size: int,
                     latency_s: float, counters: dict,
                     height: int, width: int,
                     overflow_frames: int = 0,
                     spill_retries: int = 0) -> BatchRecord:
        """counters: dict of per-frame (B,) tensors or arrays for the real
        frames.
        overflow_frames: how many of them overflowed their k_max (the
        engine's overflow-aware accounting — ends up in `snapshot()` both
        as a window sum and as the lifetime `total_overflow_frames`).
        spill_retries: SPILL-policy re-renders this batch needed before its
        capacity covered the traffic (each one a re-render at a doubled
        pass bucket); the per-frame pass usage itself arrives through the
        `spill_passes` counter and aggregates with the other counters."""
        c = host_counters(counters)
        fps = [
            pm.frame_time_s(
                pm.Workload.from_counters({k: v[i] for k, v in c.items()},
                                          height=height, width=width),
                self.hw)["fps"]
            for i in range(batch_size)
        ]
        rec = BatchRecord(
            t_done=time.perf_counter(),
            batch_size=batch_size,
            bucket_size=bucket_size,
            latency_s=latency_s,
            modeled_fps=float(np.mean(fps)) if fps else 0.0,
            counters={k: float(np.mean(v)) for k, v in c.items()},
            overflow_frames=overflow_frames,
            spill_retries=spill_retries,
        )
        self._records.append(rec)
        self.total_frames += batch_size
        self.total_batches += 1
        self.total_overflow_frames += overflow_frames
        self.total_spill_retries += spill_retries
        # Coherence counters sum exactly over the batch's real frames; the
        # same integers feed the lifetime attributes and the registry
        # counters, so the two views cannot drift.
        coherence_exact = {
            k: int(round(float(c[k].sum())))
            for k in ("tiles_reused", "tiles_recompacted",
                      "full_recompactions") if k in c
        }
        self.total_tiles_reused += coherence_exact.get("tiles_reused", 0)
        self.total_tiles_recompacted += \
            coherence_exact.get("tiles_recompacted", 0)
        self.total_full_recompactions += \
            coherence_exact.get("full_recompactions", 0)
        self._publish(rec, height, width, coherence_exact)
        return rec

    def record_request(self, *, tier: str, queue_s: float, total_s: float,
                       deadline_missed: bool = False,
                       degraded: bool = False):
        """Record one completed request from the scheduler: per-tier
        latency (rolling window for snapshot percentiles + registry
        histogram) and the deadline/degrade accounting. Rejected requests
        never complete — they go through `record_rejection` instead."""
        self.total_requests += 1
        lat = self._tier_lat.setdefault(
            tier, collections.deque(maxlen=self._tier_window))
        lat.append(total_s)
        reg = self.registry
        reg.counter("serve_requests_total",
                    "Requests completed, by priority tier",
                    ("tier",)).inc(tier=tier)
        reg.histogram("serve_request_latency_seconds",
                      "Submit->result latency per completed request",
                      ("tier",)).observe(total_s, tier=tier)
        if deadline_missed:
            self.total_deadline_misses += 1
            reg.counter("serve_deadline_misses_total",
                        "Requests completed after their deadline",
                        ("tier",)).inc(tier=tier)
        if degraded:
            self.total_degraded += 1
            reg.counter("serve_degraded_total",
                        "Requests degraded to a fallback resolution by "
                        "admission control (shed, not dropped)").inc()

    def record_rejection(self, tier: str):
        """Record one admission rejection (predicted deadline miss, no
        viable fallback): the request never rendered."""
        self.total_rejected += 1
        self.registry.counter(
            "serve_rejected_total",
            "Requests rejected at admission (predicted deadline miss "
            "with no viable fallback plan)").inc()

    def tier_snapshot(self) -> dict:
        """Per-tier latency percentiles over the rolling request window."""
        out = {}
        for tier, lat in sorted(self._tier_lat.items()):
            ms = np.array(lat) * 1e3
            out[tier] = dict(
                count=len(ms),
                p50_ms=float(np.percentile(ms, 50)),
                p95_ms=float(np.percentile(ms, 95)),
                p99_ms=float(np.percentile(ms, 99)),
            )
        return out

    def _publish(self, rec: BatchRecord, height: int, width: int,
                 coherence_exact: Optional[dict] = None):
        """Mirror the batch into the metrics registry (lifetime view)."""
        reg, res = self.registry, f"{width}x{height}"
        reg.counter("render_batches_total", "Batches rendered",
                    ("res",)).inc(res=res)
        reg.counter("render_frames_total", "Frames rendered (real, "
                    "excluding bucket padding)", ("res",)
                    ).inc(rec.batch_size, res=res)
        reg.counter("render_overflow_frames_total",
                    "Frames whose Stage-1 lists overflowed k_max"
                    ).inc(rec.overflow_frames)
        reg.counter("render_spill_retries_total",
                    "SPILL re-renders after capacity exhaustion "
                    "(each one a recompile at a doubled pass bucket)"
                    ).inc(rec.spill_retries)
        reg.histogram("render_batch_latency_seconds",
                      "Wall-clock per rendered batch", ("res",)
                      ).observe(rec.latency_s, res=res)
        reg.gauge("render_modeled_fps",
                  "Modeled FLICKER FPS of the most recent batch"
                  ).set(rec.modeled_fps)
        if "spill_passes" in rec.counters:
            reg.gauge("render_spill_passes",
                      "Mean spill passes used by the most recent batch"
                      ).set(rec.counters["spill_passes"])
        if "lod_selection_ratio" in rec.counters:
            reg.gauge("render_lod_selection_ratio",
                      "Selected fraction of the scene's Gaussians (mean "
                      "over the most recent LOD batch)"
                      ).set(rec.counters["lod_selection_ratio"])
            reg.gauge("render_lod_clusters_selected",
                      "Clusters the most recent LOD batch selected "
                      "(per-frame mean)"
                      ).set(rec.counters.get("lod_clusters_selected", 0.0))
            reg.gauge("render_lod_gaussians_selected",
                      "Gaussians the most recent LOD batch selected "
                      "(per-frame mean)"
                      ).set(rec.counters.get("lod_gaussians_selected", 0.0))
        if "tile_shards" in rec.counters:
            reg.gauge("render_tile_shards",
                      "Tile shards the most recent batch rendered across"
                      ).set(rec.counters["tile_shards"])
            reg.gauge("render_shard_entries_max",
                      "Survivor entries on the fullest tile shard (the "
                      "critical-path shard) for the most recent batch"
                      ).set(rec.counters.get("shard_entries_max", 0.0))
            reg.gauge("render_shard_entries_min",
                      "Survivor entries on the emptiest tile shard (load "
                      "balance floor) for the most recent batch"
                      ).set(rec.counters.get("shard_entries_min", 0.0))
        for key, mname, help_ in (
                ("tiles_reused", "render_tiles_reused_total",
                 "Stage-1 tile compactions skipped by the frame-coherent "
                 "incremental mode (survivor streams reused)"),
                ("tiles_recompacted", "render_tiles_recompacted_total",
                 "Tiles whose candidate set changed and were recompacted"),
                ("full_recompactions", "render_full_recompactions_total",
                 "Incremental frames that fell back to a full recompaction "
                 "(cold cache, camera jump, or changed-tile fraction)")):
            if coherence_exact is not None and key in coherence_exact:
                # The exact per-batch integer sums the lifetime total_*
                # attributes accumulate.
                reg.counter(mname, help_).inc(coherence_exact[key])

    def snapshot(self) -> dict:
        """Fold the window into a stats dict (all python scalars)."""
        recs = list(self._records)
        if not recs:
            return dict(batches=0, frames=0, p50_ms=0.0, p95_ms=0.0,
                        p99_ms=0.0, fps=0.0, modeled_fps=0.0,
                        mean_batch=0.0, overflow_frames=0,
                        total_overflow_frames=self.total_overflow_frames,
                        spill_passes=0.0, spill_retries=0,
                        total_spill_retries=self.total_spill_retries,
                        total_tiles_reused=self.total_tiles_reused,
                        total_tiles_recompacted=self.total_tiles_recompacted,
                        total_full_recompactions=(
                            self.total_full_recompactions),
                        tiers=self.tier_snapshot(),
                        total_requests=self.total_requests,
                        total_deadline_misses=self.total_deadline_misses,
                        total_degraded=self.total_degraded,
                        total_rejected=self.total_rejected,
                        counters={})
        lat_ms = np.array([r.latency_s for r in recs]) * 1e3
        frames = sum(r.batch_size for r in recs)
        # Throughput over the same window the percentiles describe: from the
        # first windowed batch's dispatch to the last one's completion (idle
        # time between batches counts — that is real serving throughput —
        # but idle/compile time before the window does not).
        span = max(recs[-1].t_done - (recs[0].t_done - recs[0].latency_s),
                   1e-9)
        # Aggregate over the UNION of counter keys across the window: a
        # counter that first appears mid-window (e.g. `spill_passes` after
        # an engine swap, or any newly added additive counter) must not be
        # silently dropped just because the window's oldest record predates
        # it. Records that lack a key contribute 0 to its mean.
        keys = sorted(set().union(*(r.counters.keys() for r in recs)))
        agg = {k: float(np.mean([r.counters.get(k, 0.0) for r in recs]))
               for k in keys}
        return dict(
            batches=len(recs),
            frames=frames,
            p50_ms=float(np.percentile(lat_ms, 50)),
            p95_ms=float(np.percentile(lat_ms, 95)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            fps=frames / span,
            modeled_fps=float(np.mean([r.modeled_fps for r in recs])),
            mean_batch=frames / len(recs),
            overflow_frames=sum(r.overflow_frames for r in recs),
            total_overflow_frames=self.total_overflow_frames,
            spill_passes=agg.get("spill_passes", 0.0),
            spill_retries=sum(r.spill_retries for r in recs),
            total_spill_retries=self.total_spill_retries,
            total_tiles_reused=self.total_tiles_reused,
            total_tiles_recompacted=self.total_tiles_recompacted,
            total_full_recompactions=self.total_full_recompactions,
            tiers=self.tier_snapshot(),
            total_requests=self.total_requests,
            total_deadline_misses=self.total_deadline_misses,
            total_degraded=self.total_degraded,
            total_rejected=self.total_rejected,
            counters=agg,
        )

    def format_snapshot(self) -> str:
        s = self.snapshot()
        line = (f"{s['frames']} frames / {s['batches']} batches "
                f"(mean batch {s['mean_batch']:.1f}) | host {s['fps']:.1f} "
                f"fps | latency p50 {s['p50_ms']:.1f} / p95 {s['p95_ms']:.1f}"
                f" / p99 {s['p99_ms']:.1f} ms | modeled FLICKER "
                f"{s['modeled_fps']:.0f} fps")
        if s["spill_passes"] > 1.0:
            line += (f" | spill {s['spill_passes']:.1f} passes/frame"
                     + (f" ({s['spill_retries']} retries)"
                        if s["spill_retries"] else ""))
        if s["overflow_frames"]:
            line += f" | OVERFLOW {s['overflow_frames']} frames in window"
        if s["total_degraded"] or s["total_rejected"] \
                or s["total_deadline_misses"]:
            line += (f" | shed {s['total_degraded']} degraded / "
                     f"{s['total_rejected']} rejected / "
                     f"{s['total_deadline_misses']} deadline misses")
        return line
