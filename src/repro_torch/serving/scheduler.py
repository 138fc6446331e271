"""Deadline-aware continuous batching with admission control.

`MicroBatcher.flush()` drains the whole queue in FIFO order — fine for a
benchmark loop, but millions-of-users traffic has *deadlines*: an AR/VR
client needs its frame inside a latency budget or not at all, while an
offline batch job just wants throughput eventually. The paper's whole
premise — contribution-aware skipping so edge hardware meets a frame
deadline — has a serving-level analogue: when the queue cannot meet a
request's deadline at full quality, shed to a cheaper plan instead of
blowing p99. `Scheduler` is that layer:

* **Priority tiers + EDF.** Requests carry a `Tier` (`INTERACTIVE` beats
  `BATCH`) and an optional relative `deadline_s`. Each dispatch is formed
  from the *pending set* by earliest-deadline-first within tier — and the
  pending set is re-evaluated after every dispatch, not once per tick, so
  a request arriving mid-drain with a tight deadline jumps the line
  (continuous batching, the LLM-serving playbook applied to rendering).
* **Executable-key grouping.** A dispatch stays homogeneous in
  `(scene, height, width)` — exactly the keys that select a compiled
  executable — and is chunked to `min(max_batch, max_batch_for(h, w))`,
  the pixel-budget batching policy large frames already serve under.
* **EWMA wall predictor.** Per executable key, an exponentially weighted
  moving average of recent batch walls. Predicted queue wait for a new
  request = the batches ahead of it (at its priority) costed by their
  keys' EWMA walls, plus its own batch — unknown keys predict 0 so a cold
  scheduler admits everything and learns from the first dispatches.
* **Admission control.** When the predicted wait would miss a request's
  deadline, the request is *degraded* to a registered lower-resolution
  fallback (`register_fallback`) — same pose and field of view through
  `core.resize_camera`, rendered through the engine's normal path, marked
  `RequestResult.degraded` — or, when no (transitive) fallback is
  predicted to meet the deadline either, *rejected at admission*: its
  future fails with `AdmissionRejected` immediately instead of queueing
  to die. Counters: `serve_degraded_total`, `serve_rejected_total`,
  `serve_deadline_misses_total{tier}` (see `serving.telemetry`).

`MicroBatcher` (serving.batching) remains as a thin compat shim over this
scheduler: deadline-free BATCH-tier submissions reduce EDF to FIFO and
never trip admission control, so its `flush()` semantics — grouping,
chunk order, futures, failure handling — are unchanged. A `session` id
given to `submit` rides on the request: sessioned and sessionless requests
share a (scene, resolution) dispatch and the engine splits them at render
time (`RenderEngine(incremental=True)`).

The scheduler is synchronous and single-threaded like the batcher it
replaces: `step()` renders one dispatch on the caller's thread, `flush()`
loops `step()` until the pending set is empty. An async front-end calls
`step()` from its event loop whenever work is pending; an open-loop
driver (`serving.workloads.replay_open_loop`) interleaves timed arrivals
with `step()` calls.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.core.camera import Camera, resize_camera
from repro_torch.serving.engine import (FrameResult, RenderEngine,
                                        RenderRequest)
from repro_torch.serving.workloads import max_batch_for


class Tier(enum.IntEnum):
    """Priority tier: lower value dispatches first."""
    INTERACTIVE = 0
    BATCH = 1

    @property
    def label(self) -> str:
        return self.name.lower()


class AdmissionRejected(RuntimeError):
    """Raised (via the request's future) when admission control predicts a
    deadline miss and no registered fallback plan is predicted to meet the
    deadline either."""


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """What a request's future resolves to."""
    frame: FrameResult
    queue_s: float            # submit -> batch dispatch
    render_s: float           # batch wall-clock (shared across the batch)
    total_s: float            # submit -> result ready
    tier: Tier = Tier.BATCH
    degraded: bool = False    # served at a fallback resolution (shed)
    deadline_missed: bool = False   # completed after its absolute deadline

    @property
    def image(self):
        return self.frame.image

    @property
    def counters(self):
        return self.frame.counters


@dataclasses.dataclass
class _Job:
    request: RenderRequest
    future: Future
    tier: Tier
    t_submit: float
    t_deadline: float         # absolute perf_counter deadline (inf = none)
    seq: int                  # arrival order (EDF tiebreak)
    degraded: bool = False

    @property
    def key(self) -> tuple:
        return (self.request.scene,
                self.request.camera.height, self.request.camera.width)

    @property
    def rank(self) -> tuple:
        """Dispatch priority: tier, then EDF, then arrival order."""
        return (int(self.tier), self.t_deadline, self.seq)


class _WallPredictor:
    """Asymmetric EWMA of recent batch walls per executable key: a wall
    *above* the current estimate replaces it immediately, a wall below it
    decays in with `alpha`. Admission uses these predictions to accept
    traffic against a deadline, so the two error directions are not
    symmetric — tracking a slowdown late turns into deadline misses on
    requests we chose to admit, tracking a speedup late only sheds a few
    requests we could have served.

    `predict` returns None for a key that has never been observed — the
    admission path treats that as 0 (admit and learn) rather than guessing
    a wall that would shed traffic a cold scheduler knows nothing about.
    """

    def __init__(self, alpha: float = 0.3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._ewma: dict[tuple, float] = {}

    def observe(self, key: tuple, wall_s: float):
        prev = self._ewma.get(key)
        self._ewma[key] = (wall_s if prev is None or wall_s > prev
                           else self.alpha * wall_s
                           + (1.0 - self.alpha) * prev)

    def predict(self, key: tuple) -> Optional[float]:
        return self._ewma.get(key)

    def seed(self, key: tuple, wall_s: float):
        """Pin a key's prediction (warm start / overload injection)."""
        self._ewma[key] = float(wall_s)


class Scheduler:
    """Continuous-batching scheduler in front of a `RenderEngine`.

    max_batch: per-dispatch chunk cap (default: the engine's). The
        effective chunk for a key is additionally bounded by the
        `max_batch_for` pixel budget unless `pixel_budget` is None.
    pixel_budget: forwarded to `workloads.max_batch_for`; None disables
        the pixel-budget bound (the MicroBatcher shim does this to keep
        its historical chunk = max_batch semantics bit-compatible).
    ewma_alpha: smoothing of the per-key batch-wall predictor.
    admission_headroom: a request is admitted when its predicted wait is
        within this fraction of its deadline. The EWMA predicts dispatch
        walls but not the slack between dispatches (future resolution,
        telemetry, the caller's own submissions), so admitting right up
        to the deadline turns every ounce of that overhead into a missed
        deadline on traffic we *chose* to accept — the reserve keeps
        admitted-p99 inside the SLO and sheds the marginal request
        instead. The default 0.7 reserves for the worst realistic p99
        stack-up: one predictor-lag window after a slowdown (the
        asymmetric EWMA snaps up only *after* the first slow dispatch)
        plus ~10% non-render cycle overhead.
    default_deadline_s / default_tier: applied when `submit` is called
        without explicit values. The defaults (None / BATCH) make a bare
        scheduler behave exactly like the old drain-everything batcher.
    """

    def __init__(self, engine: RenderEngine, *,
                 max_batch: Optional[int] = None,
                 pixel_budget: Optional[int] = 1 << 22,
                 ewma_alpha: float = 0.3,
                 admission_headroom: float = 0.7,
                 default_deadline_s: Optional[float] = None,
                 default_tier: Tier = Tier.BATCH):
        self.engine = engine
        self.max_batch = max_batch if max_batch is not None \
            else engine.max_batch
        if self.max_batch > engine.max_batch:
            raise ValueError(f"max_batch {self.max_batch} exceeds the "
                             f"engine's {engine.max_batch}")
        self.pixel_budget = pixel_budget
        if not 0.0 < admission_headroom <= 1.0:
            raise ValueError(f"admission_headroom must be in (0, 1], "
                             f"got {admission_headroom}")
        self.admission_headroom = admission_headroom
        self.predictor = _WallPredictor(ewma_alpha)
        self.default_deadline_s = default_deadline_s
        self.default_tier = default_tier
        self._queue: list[_Job] = []
        self._fallbacks: dict[tuple[int, int], tuple[int, int]] = {}
        self._next_seq = 0
        # Lifetime decision counters (telemetry mirrors them as
        # serve_degraded_total / serve_rejected_total).
        self.degraded = 0
        self.rejected = 0

    # -- admission ----------------------------------------------------------

    def register_fallback(self, height: int, width: int,
                          fb_height: int, fb_width: int):
        """Register a degrade edge: overloaded requests at (height, width)
        may be served at (fb_height, fb_width) instead. Edges chain
        (64->32 and 32->16 gives 64 two rungs), but must not cycle."""
        if (fb_height, fb_width) == (height, width):
            raise ValueError("fallback must change the resolution")
        self._fallbacks[(height, width)] = (fb_height, fb_width)
        # reject cycles eagerly — a cycle would loop the degrade walk
        seen = set()
        cur = (height, width)
        while cur in self._fallbacks:
            if cur in seen:
                del self._fallbacks[(height, width)]
                raise ValueError(f"fallback cycle through {cur}")
            seen.add(cur)
            cur = self._fallbacks[cur]

    def chunk_for(self, height: int, width: int) -> int:
        """Per-dispatch batch cap for a resolution: the scheduler cap
        intersected with the pixel-budget policy (and the engine's own)."""
        chunk = min(self.max_batch, self.engine.max_batch)
        if self.pixel_budget is not None:
            chunk = min(chunk, max_batch_for(height, width,
                                             self.pixel_budget))
        return max(chunk, 1)

    def predicted_wait_s(self, key: tuple, tier: Tier = Tier.INTERACTIVE,
                         t_deadline: float = float("-inf")) -> float:
        """Predicted submit->done wall for a hypothetical request at `key`
        dispatching after every pending job that outranks (tier,
        t_deadline): the outranking jobs' batches costed by their keys'
        EWMA walls, plus the request's own batch. Slightly conservative —
        the request may actually ride an outranking same-key batch — and
        optimistic about unseen keys (they predict 0: admit and learn)."""
        ahead: dict[tuple, int] = {}
        for j in self._queue:
            if (int(j.tier), j.t_deadline) <= (int(tier), t_deadline):
                ahead[j.key] = ahead.get(j.key, 0) + 1
        total = 0.0
        for k, count in ahead.items():
            wall = self.predictor.predict(k)
            if wall is not None:
                chunk = self.chunk_for(k[1], k[2])
                total += wall * -(-count // chunk)
        own = self.predictor.predict(key)
        return total + (own if own is not None else 0.0)

    def _admit(self, scene: str, camera: Camera, tier: Tier,
               deadline_s: Optional[float], now: float):
        """Admission decision. Returns (camera, degraded) or raises
        AdmissionRejected (after counting the rejection)."""
        if deadline_s is None:
            return camera, False
        t_deadline = now + deadline_s
        degraded = False
        budget = self.admission_headroom * deadline_s
        while True:
            key = (scene, camera.height, camera.width)
            if self.predicted_wait_s(key, tier, t_deadline) <= budget:
                return camera, degraded
            fb = self._fallbacks.get((camera.height, camera.width))
            if fb is None:
                break
            camera = resize_camera(camera, width=fb[1], height=fb[0])
            degraded = True
        self.rejected += 1
        self.engine.telemetry.record_rejection(tier.label)
        raise AdmissionRejected(
            f"predicted queue wait exceeds deadline_s={deadline_s:.3f} for "
            f"scene {scene!r} at {camera.width}x{camera.height} "
            f"({len(self._queue)} pending) and no viable fallback")

    # -- submission ---------------------------------------------------------

    def submit(self, scene: str, camera: Camera, *,
               deadline_s: Optional[float] = None,
               tier: Optional[Tier] = None,
               session: Optional[str] = None) -> Future:
        """Enqueue one request; returns a Future[RequestResult].

        deadline_s: latency budget relative to now. None (after the
        scheduler default) means no deadline — never shed, never counted
        as a miss. A request whose predicted wait already exceeds the
        budget is degraded to a registered fallback resolution or has its
        future failed with `AdmissionRejected` *now*, not after queueing.
        session: opaque client-stream id for the engine's frame-coherent
        mode (`RenderEngine(incremental=True)`).
        """
        tier = self.default_tier if tier is None else Tier(tier)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.perf_counter()
        fut: Future = Future()
        try:
            camera, degraded = self._admit(scene, camera, tier,
                                           deadline_s, now)
        except AdmissionRejected as exc:
            fut.set_exception(exc)
            return fut
        if degraded:
            self.degraded += 1
        req = RenderRequest(scene=scene, camera=camera,
                            request_id=self._next_seq, session=session)
        self._queue.append(_Job(
            request=req, future=fut, tier=tier, t_submit=now,
            t_deadline=(now + deadline_s if deadline_s is not None
                        else float("inf")),
            seq=self._next_seq, degraded=degraded))
        self._next_seq += 1
        return fut

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- dispatch -----------------------------------------------------------

    def _form_dispatch(self) -> list[_Job]:
        """The next dispatch: the most urgent pending job's executable key,
        filled with that key's pending jobs in priority order, chunked."""
        head = min(self._queue, key=lambda j: j.rank)
        peers = sorted((j for j in self._queue if j.key == head.key),
                       key=lambda j: j.rank)
        return peers[:self.chunk_for(head.key[1], head.key[2])]

    def step(self) -> int:
        """Render one dispatch (if any work is pending) and resolve its
        futures. Returns the number of requests served (failed futures
        count as served — they left the queue)."""
        if not self._queue:
            return 0
        chunk = self._form_dispatch()
        taken = {id(j) for j in chunk}
        self._queue = [j for j in self._queue if id(j) not in taken]
        t_dispatch = time.perf_counter()
        try:
            frames = self.engine.render_batch([j.request for j in chunk])
        except Exception as exc:        # fail the whole chunk's futures
            for j in chunk:
                j.future.set_exception(exc)
            return len(chunk)
        t_done = time.perf_counter()
        # Learn the *dispatch* wall (render + padding + telemetry + host
        # transfers), not the engine's inner render_s — admission predicts
        # queue drain time, and the queue drains at dispatch cadence.
        self.predictor.observe(chunk[0].key, t_done - t_dispatch)
        tele = self.engine.telemetry
        for j, frame in zip(chunk, frames):
            missed = t_done > j.t_deadline
            j.future.set_result(RequestResult(
                frame=frame,
                queue_s=t_dispatch - j.t_submit,
                render_s=frame.render_s,
                total_s=t_done - j.t_submit,
                tier=j.tier,
                degraded=j.degraded,
                deadline_missed=missed,
            ))
            tele.record_request(tier=j.tier.label,
                                queue_s=t_dispatch - j.t_submit,
                                total_s=t_done - j.t_submit,
                                deadline_missed=missed,
                                degraded=j.degraded)
        self._publish_batch(chunk, t_dispatch, frames[0].render_s)
        return len(chunk)

    def flush(self) -> int:
        """Serve until the pending set is empty, re-forming the dispatch
        after every batch (continuous batching: urgency is re-evaluated
        per dispatch, not per tick). Returns the number served."""
        served = 0
        while self._queue:
            served += self.step()
        return served

    def _publish_batch(self, chunk: list[_Job], t_dispatch: float,
                       render_s: float):
        """Per-batch queue-wait vs render split into the metrics registry —
        the knob that says whether latency is paid waiting in the pending
        set or inside the compiled render (see docs/observability.md)."""
        reg = self.engine.telemetry.registry
        queue_s = float(np.mean([t_dispatch - j.t_submit for j in chunk]))
        reg.histogram("serve_queue_wait_seconds",
                      "Mean submit->dispatch wait per batch"
                      ).observe(queue_s)
        reg.histogram("serve_render_seconds",
                      "Render wall per dispatched batch").observe(render_s)
