"""RenderEngine: multi-scene, bucketed, batched rendering on one device or
a mesh of devices.

The engine is the request-level layer above the staged render API
(`core.renderer`): it holds a registry of named `GaussianScene`s on its
device and serves whole batches of camera poses per call through
`RenderPlan.render_batch_with_stats`, which runs each spill pass's CTU and
blend once for the batch (one K1 and one K2 launch per pass on the "cuda"
backends).

Shapes are bucketed as in the reference, so that traffic reuses its plans:

  scene bucket — scenes are padded to the next power-of-two Gaussian count
                 with inert Gaussians (`core.gaussians.pad_scene`: opacity
                 below the 1/255 blend threshold, culled for every camera);
  batch bucket — batches are padded to the next power-of-two frame count
                 (at most `max_batch`) by repeating the last camera, and the
                 padding frames are sliced off the result;
  k_max        — per-scene list capacity, given or measured from a camera
                 probe set at registration (`probe_cameras=`): the longest
                 Stage-1 survivor list over the probes, pow2-bucketed.

The port has no compiler. Its plan cache is keyed like the reference's jit
cache, (scene bucket, RenderPlan, batch bucket), LRU-bounded by
`jit_cache_size`, and holds what the port builds per key: the plan
specialised to the scene's k_max, the pass bucket and the resolution (the
grid's small index tensors are rebuilt per render). `compile_count`,
`engine_compiles_total` and `engine_jit_cache_evictions_total` count its
misses and evictions under the reference's names, and a `jit_render`
span's `compile` attribute marks a miss. Every render is eager, so the
plan's stage spans nest under every dispatch's `jit_render` span, hit or
miss.

Overflow: a frame whose Stage-1 tile lists exceed the scene's k_max is
clamped; the engine then applies the plan's `OverflowPolicy` per batch on
the per-frame overflow flags — WARN (the serving default) emits a
`StreamOverflowWarning`, RAISE raises `StreamOverflowError` — and counts
`overflow_frames` into telemetry either way.

SPILL serving: with `OverflowPolicy.SPILL` the plan's k_max is the per-pass
streaming chunk and the engine derives the pass count per scene, rounded up
to a power of two. A batch that still exhausts its spill capacity
(off-probe traffic) is re-rendered with a doubled pass bucket, which sticks
for the scene, so SPILL frames never report `FrameResult.overflow`.

Sessions: on an engine built with `incremental=True`, requests that carry
a `session` id render one at a time through the frame-coherent path
(`core.coherence.render_incremental`) with a sticky per-session
`FrameCache`, which reuses the previous frame's survivor streams for the
tiles whose candidate set did not change; the frame stays bit-identical to
the batched path's full recompaction. Sessionless requests keep the
batched path. Each cache holds the frame's rows and valid bits, at
1920×1088 with 16 SPILL passes of 512 about 8160 × 8192 × 5 bytes = 334 MB
on the device, so the default `max_sessions = 64` may pin about 21 GB:
size `max_sessions` to the device.

LOD scenes: `register_scene(lod=LODConfig(...), probe_cameras=...)`
clusters and reorders the scene at registration (`repro_torch.lod.build_lod`)
and measures k_max over the probes' selected sub-scenes. Per batch the
engine selects the union of the cameras' clusters, gathers a
pow2-bucketed compact sub-scene and renders that; the selection bucket is
pinned into the plan's `LODConfig`, so it keys the plan cache like the
spill pass bucket.

Meshes: `mesh=` (a `distributed.sharding.Mesh` of torch devices) splits
each batch's frame axis over the mesh's data rows
(`serving.sharding.shard_frames`, padding an odd bucket by repeating its
last frame) and replicates scenes on every mesh device; each row's group
renders through `render_batch_with_stats` on that row's devices, and the
frames are gathered on the engine's device. `shard_tiles=S` gives the plan
a `ShardConfig(tile_shards=S)`, so every frame's tiles split over the
row's S `model` devices (one K1 and one K2 launch a pass per shard),
bit-identical to the single-device frame. Without a mesh it builds a
`serving.sharding.tile_mesh(S)` over the visible CUDA devices. Devices
may repeat: `tile_mesh(4, devices=[torch.device("cuda:0")] * 4)` runs four
virtual shards on one card.

The engine runs on `torch.device("cuda")` unless it is given another
device, and raises if CUDA is asked for and absent.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.camera import Camera, stack_cameras
from repro_torch.core.gaussians import GaussianScene, pad_scene
from repro_torch.core.pipeline import RenderConfig
from repro_torch.core import raster
from repro_torch.core.renderer import (OverflowPolicy, RenderPlan, Renderer,
                                       ShardConfig, as_plan,
                                       enforce_overflow_policy,
                                       frame_counters, measure_k_max,
                                       next_pow2)
from repro_torch.distributed import sharding as dshard
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import sharding as shd
from repro_torch.serving.telemetry import Telemetry


def scene_bucket(n: int) -> int:
    """Gaussian-count bucket a scene is padded to."""
    return next_pow2(n)


def batch_bucket(n: int, max_batch: int) -> int:
    """Frame-count bucket a batch is padded to: next power of two, clamped
    to `max_batch` (so a non-power-of-two cap is itself the top bucket and
    the padded batch never exceeds it)."""
    return min(next_pow2(n), max_batch)


@dataclasses.dataclass(frozen=True)
class RenderRequest:
    """One camera pose against one registered scene.

    session: opaque client-stream id. On an engine built with
    `incremental=True`, requests carrying a session render through the
    frame-coherent path (`core.coherence`): the engine keeps one
    `FrameCache` per session and reuses the previous frame's survivor
    streams for unchanged tiles, bit-identical to the batched path's full
    recompaction. Sessionless requests batch as before."""
    scene: str
    camera: Camera
    request_id: int = -1
    session: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FrameResult:
    """Per-request render output (one frame sliced out of its batch)."""
    request: RenderRequest
    image: torch.Tensor       # (H, W, 3) on the engine's device
    alpha: torch.Tensor       # (H, W)
    counters: dict            # 0-d tensors for this frame
    batch_size: int           # real frames in the batch that served this
    bucket_size: int          # padded frame count the batch rendered at
    render_s: float           # wall-clock of the whole batch, device-synced
    passes_run: int           # spill passes rendered, retries included
    overflow: bool = False    # this frame's Stage-1 lists were clamped


@dataclasses.dataclass(frozen=True)
class _SceneEntry:
    scene: GaussianScene      # padded to `n_bucket`, on the engine device
    n_real: int
    n_bucket: int
    k_max: int
    # LOD-registered scenes only (`register_scene(lod=...)`): the built
    # cluster table and the selection config. `scene` is then the LOD
    # build's cluster-contiguous padded member scene and `n_bucket` its
    # padded count.
    lod: Optional[object] = None          # repro_torch.lod.LODScene
    lod_cfg: Optional[object] = None      # repro_torch.lod.LODConfig
    # With a mesh: `scene` on every mesh device (`shd.replicate`).
    replicas: Optional[dict] = None


def _resolve_device(device) -> torch.device:
    """The device to serve on; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the engine was asked for CUDA but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to serve on the CPU")
    return device


class RenderEngine:
    """Registry of scenes + bucketed plan cache + batch renderer.

    base: the render configuration to serve with — a `Renderer`, a
        `RenderPlan`, or a legacy flat `RenderConfig`. Its grid resolution
        and k_max are overridden per (request resolution, scene).
    device: where scenes live and frames render (default "cuda"); with a
        mesh, where each batch's frames are gathered.
    mesh: optional `distributed.sharding.Mesh`: batches split their frame
        axis over its data rows and scenes are replicated on its devices
        (`serving.sharding`).
    max_batch: upper bound on the padded batch bucket; a larger batch
        raises.
    pad_scenes: bucket scene sizes (power-of-two padding with inert
        Gaussians).
    telemetry: where batches are recorded (a fresh `Telemetry` on the
        process-default metrics registry when None).
    overflow: the OverflowPolicy applied per batch. None keeps the base
        plan's policy, except that the core default CLAMP is upgraded to
        WARN: serving traffic should never clamp silently.
    fused: when not None, overrides the raster stage — the fused blend
        (True) or the plain per-entry fold (False). Part of the cache key.
    dataflow: when not None, overrides the plan's dataflow: "stream" (the
        survivor-stream path, O(tiles·k_max) CAT memory, the only one that
        fits production scene sizes) or "dense" (the O(regions·N) parity
        oracle).
    jit_cache_size: LRU capacity of the plan cache; past it the
        oldest-hit plan is evicted.
    max_scenes: LRU capacity of the scene registry (None = unbounded);
        least-recently-served scenes are evicted past it, and the frame
        caches of their sessions with them.
    incremental: opt into the frame-coherent serving mode: requests that
        carry a `session` id render through `core.coherence` with a sticky
        per-session `FrameCache`; sessionless requests batch as before, so
        one batch window can mix both. Telemetry gains the per-frame
        `tiles_reused` / `tiles_recompacted` / `full_recompactions`
        counters and their lifetime totals.
    coherence: a `core.CoherenceConfig` for the incremental mode's
        fallback thresholds (None = defaults).
    max_sessions: LRU capacity of the per-session frame caches. The
        least-recently-served session past it is evicted (its next frame
        pays one full recompaction, like a cold cache);
        `engine_session_evictions_total` counts these evictions and those
        of sessions whose scene left the registry.
    shard_tiles: shard the tile axis of every frame over this many devices
        (`core.renderer.ShardConfig`), the single-frame latency lever,
        orthogonal to the mesh's frame sharding (frame x tile composes on
        one mesh). When > 1 and no mesh is given, a
        `serving.sharding.tile_mesh` over the visible CUDA devices is
        built; a given mesh must carry a model axis of exactly this size.
        Output stays bit-identical to the single-device path.
    """

    def __init__(self,
                 base: Union[Renderer, RenderPlan, RenderConfig, None] = None,
                 *, device: Union[str, torch.device] = "cuda",
                 mesh: Optional[dshard.Mesh] = None,
                 max_batch: int = 64, pad_scenes: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 overflow: Union[OverflowPolicy, str, None] = None,
                 fused: Optional[bool] = None,
                 dataflow: Optional[str] = None,
                 incremental: bool = False,
                 coherence=None,
                 shard_tiles: int = 1,
                 jit_cache_size: int = 64,
                 max_scenes: Optional[int] = None,
                 max_sessions: int = 64):
        plan = RenderPlan() if base is None else as_plan(base)
        if fused is not None:
            plan = dataclasses.replace(
                plan, raster=dataclasses.replace(plan.raster, fused=fused))
        if dataflow is not None:
            plan = dataclasses.replace(plan, dataflow=dataflow)
        if overflow is None and plan.stream.overflow is OverflowPolicy.CLAMP:
            overflow = OverflowPolicy.WARN
        if overflow is not None:
            plan = dataclasses.replace(
                plan, stream=dataclasses.replace(
                    plan.stream, overflow=OverflowPolicy(overflow)))
        if shard_tiles > 1:
            plan = dataclasses.replace(
                plan, shard=ShardConfig(tile_shards=shard_tiles))
            if mesh is None:
                mesh = shd.tile_mesh(shard_tiles)
            elif mesh.shape.get("model", 1) != shard_tiles:
                raise ValueError(
                    f"shard_tiles={shard_tiles} needs a mesh whose 'model' "
                    f"axis has that size; got {dict(mesh.shape)}")
        if jit_cache_size < 1:
            raise ValueError(f"jit_cache_size must be >= 1, "
                             f"got {jit_cache_size}")
        if max_scenes is not None and max_scenes < 1:
            raise ValueError(f"max_scenes must be >= 1, got {max_scenes}")
        if max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, "
                             f"got {max_sessions}")
        self.plan = plan
        self.mesh = mesh
        self.device = _resolve_device(device)
        self.max_batch = max_batch
        self.pad_scenes = pad_scenes
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.jit_cache_size = jit_cache_size
        self.max_scenes = max_scenes
        self._scenes: OrderedDict[str, _SceneEntry] = OrderedDict()
        self._cache: OrderedDict[tuple, Callable] = OrderedDict()
        self.compile_count = 0
        self.jit_cache_evictions = 0
        self.scene_evictions = 0
        # Per-scene learned multiplier on the spill pass bucket: doubled
        # whenever a SPILL batch exhausts its capacity.
        self._spill_boost: dict[str, int] = {}
        self.spill_retries = 0
        self.incremental = incremental
        self.coherence = coherence
        self.max_sessions = max_sessions
        # Sticky per-session frame caches, LRU-bounded by max_sessions;
        # `_session_scene` records the scene each session last rendered, so
        # that evicting a scene drops the caches holding its streams. Scene
        # swaps and plan changes invalidate a cache inside
        # `render_incremental`, not here.
        self._frame_caches: OrderedDict[str, object] = OrderedDict()
        self._session_scene: dict[str, str] = {}
        self.session_evictions = 0

    # -- registry -----------------------------------------------------------

    def register_scene(self, name: str, scene: GaussianScene, *,
                       k_max: Optional[int] = None,
                       probe_cameras: Optional[Sequence[Camera]] = None,
                       lod=None) -> _SceneEntry:
        """Register (and bucket-pad) a scene under `name`, on the engine's
        device. k_max: per-tile list capacity; when None it is measured
        over `probe_cameras` if given (`core.renderer.measure_k_max`,
        capped at the scene bucket), else the padded Gaussian count.

        lod: a `repro_torch.lod.LODConfig` to serve this scene through the
        camera-dependent LOD stage. Requires `probe_cameras`: cluster
        contribution mass, and the measured k_max (which then bounds the
        selected sub-scenes, not the full scene), are measured over them.
        The scene is clustered and reordered here (`lod.build_lod`); per
        batch the engine gathers the union of the cameras' clusters. Not
        compatible with `incremental=True` (the coherence cache keys on a
        fixed scene; LOD swaps the rendered scene per batch)."""
        n_real = scene.n
        probes = (None if probe_cameras is None else
                  [c.to(self.device) for c in probe_cameras])
        if lod is not None:
            from repro_torch.lod import build_lod, measure_lod_k_max
            if probes is None:
                raise ValueError(
                    "register_scene(lod=...) needs probe_cameras — cluster "
                    "contribution mass is measured over them, not assumed")
            if self.incremental:
                raise ValueError(
                    "LOD serving is not compatible with incremental=True: "
                    "the frame-coherence cache keys on a fixed scene, but "
                    "LOD swaps the rendered sub-scene per batch")
            lod_scene = build_lod(scene.to(self.device), probes, lod,
                                  grid=self.plan.grid)
            if k_max is None:
                k_max = measure_lod_k_max(lod_scene, probes, lod,
                                          grid=self.plan.grid,
                                          cap=lod_scene.n_padded)
            entry = _SceneEntry(scene=lod_scene.scene, n_real=n_real,
                                n_bucket=lod_scene.n_padded, k_max=k_max,
                                lod=lod_scene, lod_cfg=lod)
            self.telemetry.registry.gauge(
                "engine_scene_lod_clusters",
                "LOD cluster count per LOD-registered scene",
                ("scene",)).set(lod_scene.n_clusters, scene=name)
        else:
            n_bucket = scene_bucket(n_real) if self.pad_scenes else n_real
            padded = pad_scene(scene.to(self.device), n_bucket)
            if k_max is None and probes is not None:
                # Padding is inert and culled, so it never lengthens a list.
                k_max = measure_k_max(padded, probes, grid=self.plan.grid,
                                      cap=n_bucket)
            entry = _SceneEntry(
                scene=padded, n_real=n_real, n_bucket=n_bucket,
                k_max=k_max if k_max is not None else n_bucket,
                replicas=(None if self.mesh is None else
                          shd.replicate(padded, self.mesh)))
        self._scenes[name] = entry
        self._scenes.move_to_end(name)   # re-register refreshes LRU position
        reg = self.telemetry.registry
        if self.max_scenes is not None:
            while len(self._scenes) > self.max_scenes:
                old, _ = self._scenes.popitem(last=False)
                self._spill_boost.pop(old, None)
                self.scene_evictions += 1
                reg.counter(
                    "engine_scene_evictions_total",
                    "Scenes evicted from the registry (LRU past max_scenes)"
                ).inc()
                for sid in [s for s, sc in self._session_scene.items()
                            if sc == old]:
                    self._evict_session(sid)
        reg.gauge("engine_scene_k_max", "Per-scene Stage-1 list capacity "
                  "(probe-measured or given; scene bucket when defaulted)",
                  ("scene",)).set(entry.k_max, scene=name)
        reg.gauge("engine_scene_gaussians", "Registered (real) Gaussian "
                  "count per scene", ("scene",)).set(entry.n_real, scene=name)
        return entry

    def _evict_session(self, session: str):
        """Drop one session's frame cache (LRU bound or scene eviction)."""
        self._frame_caches.pop(session, None)
        self._session_scene.pop(session, None)
        self.session_evictions += 1
        self.telemetry.registry.counter(
            "engine_session_evictions_total",
            "Incremental-session frame caches evicted (LRU past "
            "max_sessions, or their scene left the registry); the "
            "session's next frame pays one full recompaction").inc()

    def scene(self, name: str) -> GaussianScene:
        """The registered (padded, on-device) scene."""
        return self._scenes[name].scene

    def scene_names(self) -> list[str]:
        return list(self._scenes)

    def _entry(self, name: str) -> _SceneEntry:
        """Registry lookup that refreshes the scene's LRU position."""
        entry = self._scenes[name]
        self._scenes.move_to_end(name)
        return entry

    # -- plan cache ---------------------------------------------------------

    def plan_for(self, name: str, height: int, width: int,
                 lod_bucket: Optional[int] = None) -> RenderPlan:
        """The engine plan specialized to a scene's k_max and a resolution.

        Non-SPILL policies serve at the scene's k_max. SPILL keeps the
        plan's k_max as the per-pass chunk and sizes the pass count to the
        scene: next_pow2(ceil(scene k_max / chunk)), times any learned
        overflow boost, capped at the count that covers every Gaussian.

        An LOD-registered scene's plan carries its `LODConfig` with
        `selection_bucket` pinned to `lod_bucket` (the batch's gather
        capacity), which thereby joins the plan-cache key; other scenes
        serve with `plan.lod = None`."""
        entry = self._scenes[name]
        stream = self.plan.stream
        if stream.overflow is OverflowPolicy.SPILL:
            k_pass = min(stream.k_max, entry.k_max)
            if entry.k_max < entry.n_bucket:
                need = next_pow2(-(-entry.k_max // k_pass))
            else:
                # Unmeasured bound: start from the base plan's pass budget;
                # overflow retries double it.
                need = next_pow2(stream.max_spill_passes)
            passes = need * self._spill_boost.get(name, 1)
            passes = min(passes, next_pow2(-(-entry.n_bucket // k_pass)))
            stream = dataclasses.replace(stream, k_max=k_pass,
                                         max_spill_passes=passes)
        else:
            stream = dataclasses.replace(stream, k_max=entry.k_max)
        lod_cfg = None
        if entry.lod_cfg is not None:
            lod_cfg = dataclasses.replace(
                entry.lod_cfg,
                selection_bucket=(lod_bucket if lod_bucket is not None
                                  else entry.lod_cfg.selection_bucket))
        return dataclasses.replace(
            self.plan, grid=self.plan.grid.with_resolution(height, width),
            stream=stream, lod=lod_cfg)

    def _render_fn(self, n_bucket: int, plan: RenderPlan, bucket: int):
        """Returns (render callable, miss: bool) for a cache key; a miss
        builds the entry and counts as a compile."""
        key = (n_bucket, plan, bucket)
        fn = self._cache.get(key)
        miss = fn is None
        reg = self.telemetry.registry
        if miss:
            self.compile_count += 1

            def fn(scene, cams):
                return plan.render_batch_with_stats(scene, cams,
                                                    enforce=False)
            self._cache[key] = fn
            reg.counter("engine_compiles_total",
                        "Jit-cache misses (traces + compiles)").inc()
            while len(self._cache) > self.jit_cache_size:
                self._cache.popitem(last=False)
                self.jit_cache_evictions += 1
                reg.counter(
                    "engine_jit_cache_evictions_total",
                    "Executables evicted from the jit cache (LRU past "
                    "jit_cache_size); next use recompiles").inc()
            reg.gauge("engine_jit_cache_size",
                      "Compiled executables held by the engine"
                      ).set(len(self._cache))
        else:
            self._cache.move_to_end(key)   # LRU touch on a hit
        return fn, miss

    # -- rendering ----------------------------------------------------------

    def render_batch(self, requests: Sequence[RenderRequest]
                     ) -> list[FrameResult]:
        """Render a homogeneous batch (one scene, one resolution, at most
        `max_batch` requests), results in request order. Use
        `serving.batching.MicroBatcher` or `serving.scheduler.Scheduler` to
        group mixed traffic.

        Sessionless requests render in one batched render. On an
        incremental engine, requests carrying a session id peel off to the
        frame-coherent path (one `core.coherence` render each, in request
        order, so consecutive frames of a session advance its cache even
        within one batch window); each request is served exactly once."""
        requests = list(requests)
        if not requests:
            return []
        names = {r.scene for r in requests}
        if len(names) != 1:
            raise ValueError(f"mixed scenes in one batch: {sorted(names)}")
        name = requests[0].scene
        if name not in self._scenes:
            raise KeyError(f"scene {name!r} not registered "
                           f"(have {self.scene_names()})")
        res = {(r.camera.height, r.camera.width) for r in requests}
        if len(res) != 1:
            raise ValueError(f"mixed resolutions in one batch: {sorted(res)}")
        (height, width), = res
        if len(requests) > self.max_batch:
            raise ValueError(f"batch of {len(requests)} exceeds max_batch="
                             f"{self.max_batch}; split it upstream")
        coherent = ([i for i, r in enumerate(requests)
                     if r.session is not None]
                    if self.incremental else [])
        if not coherent:
            return self._render_batched(requests, name, height, width)
        results: dict[int, FrameResult] = {}
        plain = [i for i in range(len(requests))
                 if requests[i].session is None]
        if plain:
            for i, fr in zip(plain, self._render_batched(
                    [requests[i] for i in plain], name, height, width)):
                results[i] = fr
        for i in coherent:
            results[i] = self._render_incremental_one(
                requests[i], name, height, width)
        return [results[i] for i in range(len(requests))]

    def _render_batched(self, requests: Sequence[RenderRequest], name: str,
                        height: int, width: int) -> list[FrameResult]:
        entry = self._entry(name)
        n = len(requests)
        bucket = batch_bucket(n, self.max_batch)
        cameras = [r.camera.to(self.device) for r in requests]
        cameras += [cameras[-1]] * (bucket - n)   # pad: frames are pure,
        cams = stack_cameras(cameras)             # so extras are discarded

        tracer = obs_trace.current()
        retries = passes_run = 0
        scene_in, n_bucket = entry.scene, entry.n_bucket
        replicas = entry.replicas
        lod_bucket = lod_sel = None
        t0 = time.perf_counter()   # spans retries: render_s is the wall the
        with tracer.span("engine.render_batch",   # batch cost, retries incl.
                         {"scene": name, "batch": n, "bucket": bucket,
                          "res": f"{width}x{height}"}) as batch_span:
            if entry.lod is not None:
                # Camera-dependent LOD: select per camera, gather the
                # batch-union sub-scene once, render that. The gather
                # capacity is pinned into the plan below, so it keys the
                # plan cache like the spill pass bucket.
                with tracer.span("stage0_lod", {"scene": name}) as sp:
                    scene_in, lod_bucket, lod_sel = self._lod_gather(
                        entry, cameras[:n])
                    n_bucket = lod_bucket
                    if self.mesh is not None:
                        replicas = shd.replicate(scene_in, self.mesh)
                    if tracer.enabled:
                        sp.set(clusters_total=entry.lod.n_clusters,
                               bucket=lod_bucket,
                               gaussians_selected=lod_sel["union"])
            while True:
                plan = self.plan_for(name, height, width,
                                     lod_bucket=lod_bucket)
                fn, miss = self._render_fn(n_bucket, plan, bucket)
                with tracer.span("jit_render",
                                 {"compile": miss,
                                  "n_passes": plan.stream.max_spill_passes,
                                  "k_max": plan.stream.k_max}):
                    out, counters = self._dispatch(fn, scene_in, replicas,
                                                   cams)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                passes_run += plan.n_passes
                dt = time.perf_counter() - t0
                frame_overflow = out.overflow[:n].tolist()
                overflow_frames = int(sum(frame_overflow))
                spill = plan.stream.overflow is OverflowPolicy.SPILL
                capacity = plan.stream.k_max * plan.stream.max_spill_passes
                if overflow_frames and spill and capacity < n_bucket:
                    # Off-probe traffic exhausted the spill capacity: double
                    # the scene's pass bucket (it sticks) and re-render.
                    self._spill_boost[name] = \
                        2 * self._spill_boost.get(name, 1)
                    self.spill_retries += 1
                    retries += 1
                    continue
                break
            if tracer.enabled:
                batch_span.set(retries=retries,
                               overflow_frames=overflow_frames, wall_s=dt)

        # Drop padding frames, then report the real Gaussian count, not the
        # padded bucket: an LOD batch rendered its selected union.
        counters = {k: v[:n] for k, v in counters.items()}
        if "n_gaussians" in counters:
            counters["n_gaussians"] = torch.full(
                (n,), float(entry.n_real if lod_sel is None
                            else lod_sel["union"]), device=self.device)
        if lod_sel is not None:
            self._lod_counters(name, entry, counters, lod_sel, lod_bucket, n)
        self.telemetry.record_batch(batch_size=n, bucket_size=bucket,
                                    latency_s=dt, counters=counters,
                                    height=height, width=width,
                                    overflow_frames=overflow_frames,
                                    spill_retries=retries)
        if overflow_frames:
            enforce_overflow_policy(
                True, plan.stream.overflow, k_max=plan.stream.k_max,
                n_passes=plan.n_passes,
                context=f"{overflow_frames}/{n} frames of scene {name!r} "
                        f"at {height}x{width}")
        return [
            FrameResult(request=r, image=out.image[i], alpha=out.alpha[i],
                        counters=frame_counters(counters, i), batch_size=n,
                        bucket_size=bucket, render_s=dt,
                        passes_run=passes_run,
                        overflow=bool(frame_overflow[i]))
            for i, r in enumerate(requests)
        ]

    def _dispatch(self, fn, scene: GaussianScene, replicas, cams):
        """One batch render. Without a mesh, `fn(scene, cams)` under no
        mesh. With one, the frame axis splits over its data rows
        (`shard_frames`); each row's group renders on the row's first
        device, with that row's sub-mesh active for the tile shards, and
        the results are gathered on the engine's device and sliced back to
        the batch's frame count."""
        if self.mesh is None:
            return fn(scene, cams)
        parts = []
        for d, group in enumerate(shd.shard_frames(cams, self.mesh)):
            sub = self.mesh.row(d)
            with dshard.use_mesh(sub), dshard.on_device(sub.primary):
                parts.append(fn(replicas[sub.primary], group))
        n = cams.frames
        out = raster.RenderOut(*(
            torch.cat([getattr(o, f).to(self.device) for o, _ in parts])[:n]
            for f in raster.RenderOut._fields))
        counters = {k: torch.cat([c[k].to(self.device)
                                  for _, c in parts])[:n]
                    for k in parts[0][1]}
        return out, counters

    def _lod_gather(self, entry: _SceneEntry, cameras):
        """Select per camera and gather the union sub-scene for one batch.

        Returns (sub-scene sized to the selection bucket, bucket, selection
        stats: 'clusters' and 'gaussians' per frame as (B,) float32 tensors
        on the device, 'host' their float32 numpy copies and 'union' the
        union's member count). The stats reach the host in one copy."""
        from repro_torch.lod import select_clusters, selected_members
        from repro_torch.lod.select import gather_selection
        cfg, lod = entry.lod_cfg, entry.lod
        sels = torch.stack([select_clusters(lod, cam, cfg)
                            for cam in cameras])               # (B, C)
        union = sels.any(dim=0)
        f32 = torch.float32
        clusters = sels.sum(dim=1).to(f32)
        gaussians = torch.where(sels, lod.counts, torch.zeros_like(
            lod.counts)).sum(dim=1).to(f32)
        host = torch.cat([clusters.double(), gaussians.double(),
                          selected_members(lod, union).double()[None]]
                         ).cpu().numpy()
        b = len(cameras)
        n_union = int(host[-1])
        sub, bucket = gather_selection(lod, union, cfg, n_union)
        return sub, bucket, dict(
            clusters=clusters, gaussians=gaussians, union=n_union,
            host=dict(clusters=host[:b].astype(np.float32),
                      gaussians=host[b:2 * b].astype(np.float32)))

    def _lod_counters(self, name: str, entry: _SceneEntry, counters: dict,
                      lod_sel: dict, lod_bucket: int, n: int):
        """Attach the per-frame selection counters and set the scene's
        selection gauges."""
        f32 = dict(dtype=torch.float32, device=self.device)
        n_real = max(entry.lod.n_real, 1)
        counters["lod_clusters_total"] = torch.full(
            (n,), float(entry.lod.n_clusters), **f32)
        counters["lod_clusters_selected"] = lod_sel["clusters"]
        counters["lod_gaussians_selected"] = lod_sel["gaussians"]
        counters["lod_selection_ratio"] = lod_sel["gaussians"] / n_real
        counters["lod_bucket"] = torch.full((n,), float(lod_bucket), **f32)
        host = lod_sel["host"]
        reg = self.telemetry.registry
        reg.gauge("engine_lod_clusters_selected",
                  "Clusters selected per LOD scene (last-batch mean)",
                  ("scene",)).set(float(host["clusters"].mean()), scene=name)
        reg.gauge("engine_lod_gaussians_selected",
                  "Gaussians selected per LOD scene (last-batch mean)",
                  ("scene",)).set(float(host["gaussians"].mean()),
                                  scene=name)
        reg.gauge("engine_lod_selection_ratio",
                  "Selected fraction of the scene's Gaussians per LOD "
                  "scene (last-batch mean)",
                  ("scene",)).set(float((host["gaussians"] / n_real).mean()),
                                  scene=name)

    def _render_incremental_one(self, request: RenderRequest, name: str,
                                height: int, width: int) -> FrameResult:
        """Serve one sessioned frame through the frame-coherent path.

        The session's `FrameCache` is looked up (and stored back) under the
        request's session id; a scene swap or plan change (including a
        SPILL pass-bucket double) invalidates it by value inside
        `core.coherence.render_incremental`, which then serves a full
        recompaction that re-seeds it. The SPILL retry loop mirrors the
        batched path, so incremental SPILL frames never ship clamped
        either. Telemetry records the frame once (a batch of 1), with the
        coherence counters attached.
        """
        from repro_torch.core import coherence as coh
        entry = self._entry(name)
        camera = request.camera.to(self.device)
        tracer = obs_trace.current()
        retries = passes_run = 0
        t0 = time.perf_counter()
        with tracer.span("engine.render_incremental",
                         {"scene": name, "session": request.session,
                          "res": f"{width}x{height}"}) as span:
            while True:
                plan = self.plan_for(name, height, width)
                cache = self._frame_caches.get(request.session)
                with dshard.use_mesh(self.mesh):
                    out, counters, cache = coh.render_incremental(
                        plan, entry.scene, camera, cache, self.coherence,
                        enforce=False)
                self._frame_caches[request.session] = cache
                self._frame_caches.move_to_end(request.session)
                self._session_scene[request.session] = name
                while len(self._frame_caches) > self.max_sessions:
                    self._evict_session(next(iter(self._frame_caches)))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                passes_run += plan.n_passes
                overflow = bool(out.overflow)
                spill = plan.stream.overflow is OverflowPolicy.SPILL
                capacity = plan.stream.k_max * plan.stream.max_spill_passes
                if overflow and spill and capacity < entry.n_bucket:
                    self._spill_boost[name] = \
                        2 * self._spill_boost.get(name, 1)
                    self.spill_retries += 1
                    retries += 1
                    continue
                break
            dt = time.perf_counter() - t0
            if tracer.enabled:
                span.set(retries=retries, overflow=overflow, wall_s=dt,
                         tiles_reused=float(counters["tiles_reused"]),
                         tiles_recompacted=float(
                             counters["tiles_recompacted"]),
                         full_recompaction=bool(
                             float(counters["full_recompactions"])))

        counters = dict(counters)
        if "n_gaussians" in counters:   # report the real count, like the
            counters["n_gaussians"] = torch.tensor(   # batched path
                float(entry.n_real), device=self.device)
        self.telemetry.record_batch(batch_size=1, bucket_size=1,
                                    latency_s=dt, counters=counters,
                                    height=height, width=width,
                                    overflow_frames=int(overflow),
                                    spill_retries=retries)
        if overflow:
            enforce_overflow_policy(
                True, plan.stream.overflow, k_max=plan.stream.k_max,
                n_passes=plan.n_passes,
                context=f"incremental session {request.session!r} of scene "
                        f"{name!r} at {height}x{width}")
        return FrameResult(
            request=request, image=out.image, alpha=out.alpha,
            counters=counters, batch_size=1, bucket_size=1, render_s=dt,
            passes_run=passes_run, overflow=overflow)
