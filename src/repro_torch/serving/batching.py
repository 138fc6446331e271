"""Micro-batching for mixed render traffic — compat shim.

`MicroBatcher` predates the deadline-aware continuous-batching scheduler
(`serving.scheduler.Scheduler`) and is now a thin facade over it: every
submission is a deadline-free `Tier.BATCH` request, which reduces the
scheduler's EDF-within-tier dispatch order to the batcher's historical
FIFO-within-(scene, resolution) grouping, never trips admission control,
and keeps the chunk size at exactly `max_batch` (the scheduler's
pixel-budget bound is disabled). `flush()` drains the pending set on the
caller's thread — bit-compatible with the old drain-everything loop, as
the scheduler tests assert — so existing callers keep working unchanged. New code that cares about deadlines, priorities,
or overload shedding should use `Scheduler` directly.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Optional

from repro_torch.core.camera import Camera
from repro_torch.serving.engine import RenderEngine
from repro_torch.serving.scheduler import RequestResult, Scheduler, Tier

__all__ = ["MicroBatcher", "RequestResult"]


class MicroBatcher:
    """Queue + grouper in front of a `RenderEngine` (scheduler facade)."""

    def __init__(self, engine: RenderEngine,
                 max_batch: Optional[int] = None):
        self._sched = Scheduler(engine, max_batch=max_batch,
                                pixel_budget=None,
                                default_tier=Tier.BATCH)

    @property
    def engine(self) -> RenderEngine:
        return self._sched.engine

    @property
    def max_batch(self) -> int:
        return self._sched.max_batch

    @property
    def scheduler(self) -> Scheduler:
        """The underlying continuous-batching scheduler."""
        return self._sched

    def submit(self, scene: str, camera: Camera,
               session: Optional[str] = None) -> Future:
        """Enqueue one request; returns a Future[RequestResult].

        session: opaque client-stream id for the engine's frame-coherent
        incremental mode (`RenderEngine(incremental=True)`). Sessioned and
        sessionless requests group into the same (scene, resolution) batch
        window; the engine splits them at render time."""
        return self._sched.submit(scene, camera, session=session,
                                  tier=Tier.BATCH, deadline_s=None)

    @property
    def pending(self) -> int:
        return self._sched.pending

    def flush(self) -> int:
        """Drain the queue: group by (scene, resolution), render each chunk,
        resolve futures. Returns the number of requests served."""
        return self._sched.flush()
