"""Staged render API: structured configs, `RenderPlan`, `Renderer`.

The paper's pipeline is staged (Fig. 6):

    Preprocess -> Stage 1 + Compact -> CTU -> Blend

and the stage boundaries are the API. Four structured sub-configs, one per
resource the stages consume, plus a dataflow selector:

    GridConfig    image tiling hierarchy (height/width/tile/subtile/minitile)
    TestConfig    hierarchical test: method (aabb | obb | cat), leader-pixel
                  sampling mode, CTU precision scheme, spiky threshold, and
                  the CTU backend ("torch" | "cuda" — the PRTU kernels)
    StreamConfig  survivor-stream resources: k_max per pass and the
                  OverflowPolicy applied when a tile list exceeds it
    RasterConfig  blend stage: background and the raster backend
                  (fused=True routes through the fused CUDA blend kernel)

`RenderPlan` assembles them into stage callables:

    preprocess(scene, camera)       -> ProjectedScene
    stage1_compact(ProjectedScene)  -> tuple[TileStream, ...]  (1 per pass)
    ctu(ProjectedScene, TileStream) -> StreamHierarchyOut      (per pass)
    _blend_passes(ProjectedScene, [StreamHierarchyOut, ...])
                                    -> RenderOut (+ blend counters)

Under `OverflowPolicy.SPILL` the plan runs `StreamConfig.max_spill_passes`
compacted passes: each pass's entries go through the CTU and the blend
folds the passes front to back through carried state, so overflow entries
render instead of being clamped while per-pass memory stays at the k_max
size.

`RenderPlan.render_batch_with_stats` renders B camera poses of one scene:
preprocess and Stage 1 run per frame, then the CTU and the blend of pass
i run once for all frames, folded into the tile axis
(`core.hierarchy.FrameFold`), so the "cuda" backends launch K1 and K2
once per pass for the batch. Each frame equals `render_with_stats` of its
own camera bit for bit; `render_with_stats` is the batch of one.

`RenderPlan.lod` (default None) attaches the camera-dependent LOD stage
(`repro_torch.lod.LODConfig`): `render_lod_with_stats` selects a scene's
clusters for the camera and gathers a pow2-bucketed sub-scene before Stage
1, under a `stage0_lod` span in front of the usual tree. Every other entry
point ignores the field.

Every render emits a host-side span tree on the active tracer
(`repro_torch.obs.trace`, NoopTracer by default):

    render
    ├── preprocess       (per frame)
    ├── stage1_compact   (per frame)
    ├── ctu   [pass=i]   (x n_passes, with that pass's CTU counters)
    ├── blend [pass=i]   (x n_passes, with processed/blended deltas)
    └── finalize

For a batch the ctu and blend attributes are sums over its frames and the
finalize and root ones per-frame means; with one frame they are the
reference's eager tree and attributes.

`RenderPlan.dataflow` selects how the hierarchy materializes between
Stage 1 and the CTU: "stream" (the default: compact first, CTU on
survivors only, O(T·k_max·16) masks) or "dense" (the O(regions·N) parity
oracle, which every stream quantity must match). The AABB (vanilla 3DGS)
and OBB (GSCore) baselines compact their own dense tile masks.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional, TYPE_CHECKING

import torch

from repro_torch.core.gaussians import GaussianScene, Projected, project, \
    classify_spiky
from repro_torch.core.culling import TileGrid, aabb_mask, tile_chunk
from repro_torch.core.cat import SamplingMode
from repro_torch.core import hierarchy as H
from repro_torch.core import raster
from repro_torch.core.precision import PrecisionScheme, MIXED
from repro_torch.obs import trace as obs_trace

if TYPE_CHECKING:
    from repro_torch.lod.build import LODScene
    from repro_torch.lod.config import LODConfig

BACKENDS = ("torch", "cuda")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Image tiling hierarchy (the Preprocess/Stage-1 spatial layout)."""
    height: int = 128
    width: int = 128
    tile: int = 16
    subtile: int = 8
    minitile: int = 4

    def make(self) -> TileGrid:
        return TileGrid(self.height, self.width, self.tile, self.subtile,
                        self.minitile)

    def with_resolution(self, height: int, width: int) -> "GridConfig":
        return dataclasses.replace(self, height=height, width=width)


@dataclasses.dataclass(frozen=True)
class TestConfig:
    """Hierarchical-test stage (Stage-1 AABB + Mini-Tile CAT in the CTU)."""
    __test__ = False          # "Test" prefix: keep pytest collection away
    method: str = "cat"                      # aabb | obb | cat
    mode: SamplingMode = SamplingMode.SMOOTH_FOCUSED
    precision: PrecisionScheme = MIXED
    spiky_threshold: float = 3.0
    backend: str = "torch"                   # torch | cuda (PRTU kernel)

    def __post_init__(self):
        if self.method not in ("aabb", "obb", "cat"):
            raise ValueError(f"unknown method {self.method!r} "
                             "(expected 'aabb', 'obb' or 'cat')")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown test backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")


class OverflowPolicy(enum.Enum):
    """What to do when a tile's Stage-1 survivor list exceeds `k_max`.

    CLAMP drops entries past k_max silently, WARN warns, RAISE raises.
    SPILL renders the overflow entries in extra passes of k_max entries
    each (pass p holds survivors p*k_max..(p+1)*k_max-1), bit-identical to
    one pass over the concatenated lists; its flag fires only when the
    total capacity (max_spill_passes * k_max) is exceeded, and warns.
    """
    CLAMP = "clamp"
    WARN = "warn"
    RAISE = "raise"
    SPILL = "spill"


class StreamOverflowWarning(RuntimeWarning):
    """A frame's Stage-1 tile list overflowed its capacity and was clamped."""


class StreamOverflowError(RuntimeError):
    """A frame's Stage-1 tile list overflowed k_max under RAISE."""


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Survivor-stream resources (Compact stage): k_max is the per-tile list
    capacity per pass; SPILL runs `max_spill_passes` passes (empty trailing
    passes blend nothing), every other policy exactly one."""
    k_max: int = 1024
    overflow: OverflowPolicy = OverflowPolicy.CLAMP
    max_spill_passes: int = 4

    def __post_init__(self):
        if not isinstance(self.overflow, OverflowPolicy):
            object.__setattr__(self, "overflow",
                               OverflowPolicy(self.overflow))
        if self.max_spill_passes < 1:
            raise ValueError(
                f"max_spill_passes must be >= 1, got {self.max_spill_passes}")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Blend stage (VRU array)."""
    background: float = 0.0
    fused: bool = False                       # fused CUDA blend kernel


@dataclasses.dataclass(frozen=True)
class ProjectedScene:
    """Preprocess-stage output: screen-space Gaussians + the tile grid."""
    proj: Projected
    grid: TileGrid


@dataclasses.dataclass(frozen=True)
class TileStream:
    """One compacted pass of per-tile depth-ordered survivor streams; pass
    `index` holds survivors index*k_max..(index+1)*k_max-1 of each tile's
    list, and `overflow` is the frame's flag (same in every pass).

    `dense` carries the full-mask `HierarchyOut` of the dense oracle;
    `baseline_sub` and `counters` the OBB baseline's (S, N) sub-tile mask
    and the baselines' workload counters. All three are None on the stream dataflow and are
    shared (the same tensors) by the passes of a frame."""
    lists: torch.Tensor                       # (T, K) int32 gaussian ids
    valid: torch.Tensor                       # (T, K) bool
    overflow: torch.Tensor                    # () bool
    dense: Optional[H.HierarchyOut] = None
    baseline_sub: Optional[torch.Tensor] = None
    counters: Optional[dict] = None
    index: int = 0


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """An executable, hashable composition of the render stages. dataflow
    is "stream" (survivor streams, the default) or "dense" (the parity
    oracle). lod (default None) is the optional LOD stage's
    `repro_torch.lod.LODConfig`, read only by `render_lod_with_stats`.
    Tensors stay on the device of the scene and camera they are given."""
    grid: GridConfig = GridConfig()
    test: TestConfig = TestConfig()
    stream: StreamConfig = StreamConfig()
    raster: RasterConfig = RasterConfig()
    dataflow: str = "stream"                  # stream | dense
    lod: Optional["LODConfig"] = None

    def __post_init__(self):
        if self.dataflow not in ("stream", "dense"):
            raise ValueError(f"unknown dataflow {self.dataflow!r} "
                             "(expected 'stream' or 'dense')")

    def preprocess(self, scene: GaussianScene, camera) -> ProjectedScene:
        """Projection + 3σ screen-space footprints (preprocessing core)."""
        return ProjectedScene(proj=project(scene, camera),
                              grid=self.grid.make())

    @property
    def n_passes(self) -> int:
        """Spill pass count: max_spill_passes under SPILL, else 1."""
        return (self.stream.max_spill_passes
                if self.stream.overflow is OverflowPolicy.SPILL else 1)

    def stage1_compact(self, ps: ProjectedScene) -> tuple[TileStream, ...]:
        """Stage-1 test + depth sort + per-tile list compaction. One
        `TileStream` per spill pass.

        stream: the tile-level AABB (the OR of the tile's sub-tile AABBs),
        fused into the compaction and chunked over tiles.
        dense: the full dense hierarchy runs here (the oracle needs every
        mask anyway; the "cuda" backend takes its CAT from the dense PRTU
        kernel) and the tile lists derive from its sub-tile bits.
        baselines: `hierarchy.baseline_masks` for the method.
        """
        proj, grid = ps.proj, ps.grid
        k_max, n_passes = self.stream.k_max, self.n_passes

        def as_streams(lists, valid, overflow, **shared):
            return tuple(TileStream(lists[p], valid[p], overflow, index=p,
                                    **shared) for p in range(n_passes))

        order = raster.depth_order(proj)
        if self.test.method != "cat":
            tile_mask, sub_mask, counters = H.baseline_masks(
                proj, grid, self.test.method)
            return as_streams(*raster.compact_tile_lists_passes(
                tile_mask, order, k_max, n_passes),
                baseline_sub=sub_mask, counters=counters)
        if self.dataflow == "dense":
            args = (proj, grid, self.test.mode, self.test.precision,
                    self.test.spiky_threshold)
            if self.test.backend == "cuda":
                from repro_torch.kernels import ops as kops
                hout = kops.hierarchical_test_cuda(*args)
            else:
                hout = H.hierarchical_test(*args)
            # The CTU's input stream: Stage-1 survivors per tile.
            stage1_tile = grid.tile_or(hout.subtile_mask, grid.subtile)
            return as_streams(*raster.compact_tile_lists_passes(
                stage1_tile, order, k_max, n_passes), dense=hout)
        return as_streams(*raster.compact_aabb_tile_lists(
            proj, grid, order, k_max, n_passes))

    def ctu(self, ps: ProjectedScene, ts: TileStream) -> H.StreamHierarchyOut:
        """Per-entry hierarchical testing (the queue-fed CTU of Fig. 6).

        stream: Stage-1 sub-tile bits + Mini-Tile CAT on list entries only;
        the "cuda" backend routes the CAT through the entry PRTU kernel.
        dense/baselines: the masks already exist — gather them at the
        compacted entries (`raster.entry_mask_from_dense`).
        """
        if self.test.method != "cat":
            entry = (None if ts.baseline_sub is None else
                     raster.entry_mask_from_dense(ps.grid, ts.baseline_sub,
                                                  ts.lists,
                                                  size=ps.grid.subtile))
            return H.StreamHierarchyOut(
                lists=ts.lists, valid=ts.valid, entry_sub_mask=None,
                entry_mini_mask=entry, overflow=ts.overflow,
                counters=ts.counters)
        if self.dataflow == "dense":
            entry = raster.entry_mask_from_dense(
                ps.grid, ts.dense.minitile_mask, ts.lists)
            return H.StreamHierarchyOut(
                lists=ts.lists, valid=ts.valid, entry_sub_mask=None,
                entry_mini_mask=entry, overflow=ts.overflow,
                counters=ts.dense.counters)
        hout, = self._ctu_frames([ps], H.fold_frames([ps.proj], ps.grid),
                                 [ts])
        return hout

    def _ctu_frames(self, pss, fold: H.FrameFold, tss):
        """`ctu` of one pass of B frames: on the stream CAT one evaluation
        over the frame fold (one K1 launch on the "cuda" backend); the
        dense oracle and the baselines gather per frame."""
        if self.test.method != "cat" or self.dataflow != "stream":
            return [self.ctu(ps, ts) for ps, ts in zip(pss, tss)]
        cat_fn = None
        if self.test.backend == "cuda":
            from repro_torch.kernels import ops as kops
            cat_fn = kops.entry_cat_fn(self.test.mode, self.test.precision,
                                       self.test.spiky_threshold)
        return H.stream_entry_test_frames(
            fold, [ps.proj for ps in pss], pss[0].grid,
            [ts.lists for ts in tss], [ts.valid for ts in tss],
            [ts.overflow for ts in tss], self.test.mode,
            self.test.precision, self.test.spiky_threshold, cat_fn=cat_fn)

    def _blend_passes(self, ps: ProjectedScene, houts):
        """Blend one frame's spill passes front to back from one carried
        state. Returns (RenderOut, blend counters, per-pass entry_alive
        list)."""
        return self._blend_frames(H.fold_frames([ps.proj], ps.grid),
                                  ps.grid, [houts],
                                  obs_trace.NoopTracer())[0]

    def _blend_frames(self, fold: H.FrameFold, grid: TileGrid, houts,
                      tracer):
        """Blend B frames' spill passes, pass i of every frame in one fold
        (one K2 launch when fused), each under a `blend[pass=i]` span.
        houts: per frame, its per-pass `StreamHierarchyOut`s. Returns one
        (RenderOut, blend counters, per-pass entry_alive list) per frame."""
        device = fold.proj.depth.device
        n_pass = len(houts[0])
        passes = [[(h[i].lists, h[i].valid, h[i].entry_mini_mask)
                   for h in houts] for i in range(n_pass)]
        overflows = [h[0].overflow for h in houts]
        prev = [0.0, 0.0]

        def note(sp, processed, blended, alive):
            tracer.block((processed, blended, alive))
            if tracer.enabled:
                proc = float(processed.sum(dtype=torch.float64))
                bl = float(blended.sum(dtype=torch.float64))
                sp.set(processed_delta=proc - prev[0],
                       blended_delta=bl - prev[1],
                       entries_alive=float(alive.sum()))
                prev[:] = [proc, bl]

        if self.raster.fused:
            from repro_torch.kernels import ops as kops
            results = kops.render_tiles_fused_frames(
                fold, grid, passes, self.raster.background, overflows,
                span_cb=lambda i: tracer.span(
                    "blend", {"pass": i, "backend": "cuda"}),
                pass_cb=lambda sp, fb: note(sp, fb.processed, fb.blended,
                                            fb.entry_alive))
        else:
            state = raster.init_blend_state(fold.frames * grid.num_tiles,
                                            grid.tile ** 2, device)
            alive_parts = []
            for i, frames in enumerate(passes):
                lists, valid, masks = zip(*frames)
                with tracer.span("blend",
                                 {"pass": i, "backend": "torch"}) as sp:
                    state, alive = raster.blend_pass(
                        fold.proj, grid, fold.ids(lists), fold.cat(valid),
                        fold.cat(masks), state,
                        tile_origins=fold.tile_origins)
                    note(sp, state.processed, state.blended, alive)
                alive_parts.append(alive)
            entry_alive = torch.cat(alive_parts, dim=1)
            # The unfused sweep always walks every padded list slot.
            swept = float(sum(frames[0][0].shape[1] for frames in passes))
            results = []
            for b in range(fold.frames):
                rows = fold.rows(b, grid.num_tiles)
                out = raster.finalize_blend(
                    grid, raster.BlendState(*(x[rows] for x in state)),
                    self.raster.background, overflows[b], entry_alive[rows])
                results.append((out, dict(swept_per_pixel=torch.tensor(
                    swept, device=device))))
        frames = []
        for out, counters in results:
            counters = dict(counters)
            counters["processed_per_pixel"] = out.processed_per_pixel.mean()
            counters["blended_per_pixel"] = out.blended_per_pixel.mean()
            k = out.entry_alive.shape[1] // n_pass
            alive_parts = [out.entry_alive[:, i * k:(i + 1) * k]
                           for i in range(n_pass)]
            frames.append((out, counters, alive_parts))
        return frames

    def _merge_hout_counters(self, houts) -> dict:
        """Fold per-pass CTU counters into frame totals. The stream CAT's
        per-entry sums add across passes (the scene-level ones are pass
        0's); the dense oracle's and the baselines' counters are full-mask
        sums, the same in every pass, so pass 0's dict is the total."""
        counters = dict(houts[0].counters)
        if self.dataflow == "stream" and self.test.method == "cat":
            for h in houts[1:]:
                for key in H.ADDITIVE_COUNTER_KEYS:
                    counters[key] = counters[key] + h.counters[key]
        return counters

    def render_with_stats(self, scene: GaussianScene, camera, *,
                          enforce: bool = True):
        """Run the full plan: returns (RenderOut, counters dict).

        Under SPILL: one CTU evaluation and one blend fold per compacted
        pass, sharing one carried blend state. enforce=False skips the
        overflow policy (the serving engine applies SPILL itself, retrying
        with more passes before a frame may report overflow)."""
        (out, counters), = self._render_frames(scene, [camera], enforce)
        return out, counters

    def render(self, scene: GaussianScene, camera) -> raster.RenderOut:
        out, _ = self.render_with_stats(scene, camera)
        return out

    def render_incremental(self, scene: GaussianScene, camera, cache=None,
                           cfg=None, **kw):
        """Frame-coherent render: reuse the previous frame's per-tile
        survivor streams for every tile whose Stage-1 candidate set is
        provably unchanged, recompacting only the rest (bit-identical to
        `render_with_stats`; see `core.coherence`).

        cache: the `coherence.FrameCache` returned by the previous call
        (None = cold start, a full recompaction that seeds one).
        cfg: a `coherence.CoherenceConfig` (fallback thresholds).
        Returns (RenderOut, counters, FrameCache).
        """
        from repro_torch.core import coherence
        return coherence.render_incremental(self, scene, camera, cache=cache,
                                            cfg=cfg, **kw)

    def render_batch_with_stats(self, scene: GaussianScene, cameras, *,
                                enforce: bool = True):
        """Render B camera poses of one scene: preprocess and Stage 1 per
        frame, then each pass's CTU and blend once for all frames (one K1
        and one K2 launch per pass on the "cuda" backends). Under SPILL
        every frame runs the plan's pass count; a frame with fewer passes
        has empty later passes, on which K1 exits early and K2 runs no
        K-block.

        cameras: a batched `Camera` (`core.camera.stack_cameras`) at the
        plan's resolution. Each frame equals `render_with_stats` of its own
        camera bit for bit. The overflow policy applies to the batch (on
        any frame's flag) unless enforce=False. Returns (RenderOut with a
        leading frame axis, counters dict of (B,) tensors)."""
        if (cameras.height, cameras.width) != (self.grid.height,
                                               self.grid.width):
            raise ValueError(
                f"camera resolution {(cameras.height, cameras.width)} != "
                f"plan grid {(self.grid.height, self.grid.width)}")
        frames = self._render_frames(
            scene, [cameras.frame(b) for b in range(cameras.frames)],
            enforce)
        out = raster.RenderOut(*(torch.stack(f) for f in
                                 zip(*(o for o, _ in frames))))
        counters = {k: torch.stack([c[k] for _, c in frames])
                    for k in frames[0][1]}
        return out, counters

    def render_lod_with_stats(self, lod_scene: "LODScene", camera):
        """Camera-dependent LOD render: select clusters, gather the compact
        sub-scene, run the plan on it (a `stage0_lod` span in front of the
        usual `render` tree).

        Requires `plan.lod` (a `repro_torch.lod.LODConfig`) and a
        `LODScene` from `repro_torch.lod.build_lod`. The selection bucket
        (the gather capacity) is `lod.selection_bucket` when pinned (the
        serving engine pins it per batch, and it keys the plan cache) and
        otherwise derived from the selected member count. Every render here
        is eager, so the selected count is always known on the host: the
        reference's refusal of an unpinned bucket under jit/vmap has no
        counterpart. Returns (RenderOut, counters) like `render_with_stats`
        plus lod_clusters_total / lod_clusters_selected /
        lod_gaussians_selected / lod_selection_ratio / lod_bucket."""
        cfg = self.lod
        if cfg is None:
            raise ValueError("render_lod_with_stats needs a plan with "
                             "lod=LODConfig(...) (this plan has lod=None)")
        from repro_torch.lod.select import (gather_selection, select_clusters,
                                            selected_members)
        tracer = obs_trace.current()
        with tracer.span("stage0_lod") as sp:
            sel = select_clusters(lod_scene, camera, cfg)
            n_sel = selected_members(lod_scene, sel)
            sub, bucket = gather_selection(lod_scene, sel, cfg, n_sel)
            tracer.block(sub)
            if tracer.enabled:
                sp.set(clusters_total=lod_scene.n_clusters, bucket=bucket,
                       traced=False, clusters_selected=int(sel.sum()),
                       gaussians_selected=int(n_sel))
        out, counters = self.render_with_stats(sub, camera)
        device = n_sel.device
        f32 = torch.float32
        counters = dict(counters)
        counters["lod_clusters_total"] = torch.tensor(
            float(lod_scene.n_clusters), dtype=f32, device=device)
        counters["lod_clusters_selected"] = sel.sum().to(f32)
        counters["lod_gaussians_selected"] = n_sel.to(f32)
        counters["lod_selection_ratio"] = (
            n_sel.to(f32) / float(max(lod_scene.n_real, 1)))
        counters["lod_bucket"] = torch.tensor(float(bucket), dtype=f32,
                                              device=device)
        return out, counters

    def _render_frames(self, scene: GaussianScene, cameras,
                       enforce: bool = True):
        """The render of B frames under one `render` span: per-frame
        preprocess and Stage 1, then `_render_streams_frames`. Returns one
        (RenderOut, counters) per camera."""
        tracer = obs_trace.current()
        batch = len(cameras)
        with tracer.span("render") as root:
            if tracer.enabled:
                root.set(dataflow=self.dataflow, method=self.test.method,
                         k_max=self.stream.k_max, n_passes=self.n_passes,
                         overflow_policy=self.stream.overflow.value,
                         fused=self.raster.fused, tile_shards=1,
                         height=self.grid.height, width=self.grid.width,
                         plan_first_call=tracer.mark_first(self),
                         traced=False, frames=batch)
            pss, streams = [], []
            for b, camera in enumerate(cameras):
                frame = {"frame": b} if batch > 1 else None
                with tracer.span("preprocess", frame) as sp:
                    ps = self.preprocess(scene, camera)
                    tracer.block(ps)
                    if tracer.enabled:
                        sp.set(n_gaussians=int(ps.proj.depth.shape[0]),
                               tiles=int(ps.grid.num_tiles))
                with tracer.span("stage1_compact", frame) as sp:
                    tss = self.stage1_compact(ps)
                    tracer.block(tss)
                    if tracer.enabled:
                        sp.set(survivors_per_pass=[
                            float(ts.valid.sum()) for ts in tss],
                            overflow=bool(tss[0].overflow))
                pss.append(ps)
                streams.append(tss)
            frames = self._render_streams_frames(pss, streams, tracer, root)
        if enforce:
            enforce_overflow_policy(
                any(bool(out.overflow) for out, _ in frames),
                self.stream.overflow, k_max=self.stream.k_max,
                n_passes=self.n_passes)
        return frames

    def _render_streams(self, ps: ProjectedScene, streams):
        """The post-Stage-1 tail of one frame: CTU per pass, counter merge,
        blend fold, finalize. Returns (RenderOut, counters dict)."""
        (out, counters), = self._render_streams_frames(
            [ps], [streams], obs_trace.current())
        return out, counters

    def _render_streams_frames(self, pss, streams, tracer, root=None):
        """The post-Stage-1 tail of B frames (`pss`, and per frame its
        tuple of pass streams): pass i's CTU and blend once over the frame
        fold, then the per-frame counter merge and finalize. Returns one
        (RenderOut, counters dict) per frame."""
        grid = pss[0].grid
        batch = len(pss)
        fold = H.fold_frames([ps.proj for ps in pss], grid)
        houts = [[] for _ in pss]
        for i in range(len(streams[0])):
            with tracer.span("ctu", {"pass": i}) as sp:
                pass_h = self._ctu_frames(pss, fold, [s[i] for s in streams])
                tracer.block(pass_h)
                if tracer.enabled and pass_h[0].counters:
                    keys = [k for k, v in pass_h[0].counters.items()
                            if v.dim() == 0]
                    vals = torch.stack([h.counters[k].double()
                                        for h in pass_h for k in keys])
                    sums = vals.view(batch, len(keys)).sum(dim=0).tolist()
                    sp.set(**dict(zip(keys, sums)))
            for frame, h in zip(houts, pass_h):
                frame.append(h)
        counters = [self._merge_hout_counters(h) for h in houts]
        cat = self.test.method == "cat"
        if cat:
            for ps, c in zip(pss, counters):
                c["cat_mask_bytes"] = torch.tensor(
                    float(cat_mask_elems(ps.grid, ps.proj.depth.shape[0],
                                         self.stream.k_max, self.dataflow)),
                    device=ps.proj.depth.device)
        blended = self._blend_frames(fold, grid, houts, tracer)
        frames = []
        with tracer.span("finalize") as sp:
            for ps, ts, h, c, (out, blend_counters, alive_parts) in zip(
                    pss, streams, houts, counters, blended):
                c.update(blend_counters)
                if cat:
                    eff: dict = {}
                    for t, hout, alive in zip(ts, h, alive_parts):
                        for key, v in self._effective_counters(
                                ps, t, hout, alive).items():
                            eff[key] = v if key not in eff else eff[key] + v
                    c.update(eff)
                # Passes that actually carried entries (>= 1 even on an
                # empty frame).
                used = sum(int(x.valid.any()) for x in h)
                c["spill_passes"] = torch.tensor(
                    float(max(used, 1)), device=ps.proj.depth.device)
                frames.append((out, c))
            tracer.block(frames)
            if tracer.enabled:
                sp.set(spill_passes=_frame_mean(frames, "spill_passes"),
                       overflow=any(bool(o.overflow) for o, _ in frames))
                if root is not None:
                    root.set(**{k: _frame_mean(frames, k) for k in
                                ("processed_per_pixel", "blended_per_pixel",
                                 "vru_pairs", "spill_passes")
                                if k in frames[0][1]
                                and frames[0][1][k].dim() == 0})
        return frames

    # -- effective (termination-aware) counters -----------------------------

    def _prs_per_subtile(self, proj: Projected) -> torch.Tensor:
        """(N,) PRs the CTU evaluates per hit sub-tile: 4 dense / 2 sparse
        per Fig. 3(b), adaptive modes pick per Gaussian."""
        spiky = classify_spiky(proj.axis_ratio, self.test.spiky_threshold)
        four = torch.full(spiky.shape, 4.0, device=spiky.device)
        two = torch.full(spiky.shape, 2.0, device=spiky.device)
        if self.test.mode == SamplingMode.UNIFORM_DENSE:
            return four
        if self.test.mode == SamplingMode.UNIFORM_SPARSE:
            return two
        if self.test.mode == SamplingMode.SMOOTH_FOCUSED:
            return torch.where(spiky, two, four)
        return torch.where(spiky, four, two)

    def _effective_counters(self, ps: ProjectedScene, ts: TileStream,
                            hout: H.StreamHierarchyOut, entry_alive) -> dict:
        """Termination-aware CTU/VRU workload: for each list entry processed
        before its tile terminated, one PR batch per hit sub-tile and one
        mini-tile blend per CAT-passing mini-tile. On the stream dataflow
        the per-entry masks are those quantities; on the dense oracle the
        sub-tile and mini-tile bits are gathered at the entries from the
        full masks through the tile's image-global region ids."""
        idx = hout.lists.clamp_min(0).long()                     # (T, K)
        if self.dataflow == "stream":
            sub = hout.entry_sub_mask                            # (T, K, Sp)
            mini = hout.entry_mini_mask                          # (T, K, Mt)
        else:
            device = idx.device
            sub = ts.dense.subtile_mask[
                ps.grid.global_subtile_ids(device)[:, None, :],
                idx[:, :, None]]
            mini = ts.dense.minitile_mask[
                ps.grid.global_minitile_ids(device)[:, None, :],
                idx[:, :, None]]
        sub_hits = sub.sum(dim=-1)                               # (T, K)
        mini_hits = mini.sum(dim=-1)
        prs = self._prs_per_subtile(ps.proj).double()[idx]
        f32 = torch.float32
        return dict(
            ctu_pairs_eff=(sub_hits * entry_alive).sum().to(f32),
            ctu_prs_eff=H.exact_f32(sub_hits * prs * entry_alive),
            vru_pairs_eff=(mini_hits * entry_alive).sum().to(f32),
            ctu_stream_len=entry_alive.sum().to(f32),
        )


class Renderer:
    """User-facing facade over a `RenderPlan`.

        r = Renderer(test=TestConfig(backend="cuda"),
                     stream=StreamConfig(k_max=512,
                                         overflow=OverflowPolicy.SPILL),
                     raster=RasterConfig(fused=True))
        out, counters = r.render_with_stats(scene, camera)

    Omitted sub-configs take their defaults (CAT, SMOOTH_FOCUSED, MIXED).
    """

    def __init__(self, grid: Optional[GridConfig] = None,
                 test: Optional[TestConfig] = None,
                 stream: Optional[StreamConfig] = None,
                 raster: Optional[RasterConfig] = None,
                 dataflow: str = "stream",
                 lod: Optional["LODConfig"] = None):
        self.plan = RenderPlan(
            grid=grid if grid is not None else GridConfig(),
            test=test if test is not None else TestConfig(),
            stream=stream if stream is not None else StreamConfig(),
            raster=raster if raster is not None else RasterConfig(),
            dataflow=dataflow, lod=lod)

    @classmethod
    def from_plan(cls, plan: RenderPlan) -> "Renderer":
        r = cls.__new__(cls)
        r.plan = plan
        return r

    def replace(self, **kw) -> "Renderer":
        """New Renderer with plan fields replaced (grid/test/stream/raster/
        dataflow/lod)."""
        return Renderer.from_plan(dataclasses.replace(self.plan, **kw))

    def render(self, scene: GaussianScene, camera) -> raster.RenderOut:
        return self.plan.render(scene, camera)

    def render_with_stats(self, scene: GaussianScene, camera):
        return self.plan.render_with_stats(scene, camera)

    def render_incremental(self, scene: GaussianScene, camera, cache=None,
                           cfg=None, **kw):
        return self.plan.render_incremental(scene, camera, cache=cache,
                                            cfg=cfg, **kw)

    def render_batch_with_stats(self, scene: GaussianScene, cameras):
        return self.plan.render_batch_with_stats(scene, cameras)

    def render_lod_with_stats(self, lod_scene: "LODScene", camera):
        return self.plan.render_lod_with_stats(lod_scene, camera)

    def __repr__(self):
        return f"Renderer({self.plan!r})"


def _frame_mean(frames, key: str) -> float:
    """Mean over frames of a 0-d counter (the value itself for one)."""
    return sum(float(c[key]) for _, c in frames) / len(frames)


def frame_counters(counters: dict, i: int) -> dict:
    """Slice frame `i`'s scalars out of a batched counters dict."""
    return {k: v[i] for k, v in counters.items()}


def enforce_overflow_policy(overflow, policy: OverflowPolicy, *,
                            k_max: int, n_passes: int = 1,
                            context: str = "") -> bool:
    """Apply an OverflowPolicy to an overflow flag: CLAMP ignores it, WARN
    and SPILL warn, RAISE raises. Returns True iff overflow was observed
    (and not raised)."""
    if policy is OverflowPolicy.CLAMP or not bool(overflow):
        return False
    suffix = " — " + context if context else ""
    if policy is OverflowPolicy.SPILL:
        warnings.warn(
            f"Stage-1 tile list overflowed the spill capacity "
            f"k_max={k_max} x {n_passes} passes; entries past it were "
            f"dropped (clamped){suffix}. Raise StreamConfig.max_spill_passes "
            f"(or k_max) to cover the longest survivor list.",
            StreamOverflowWarning, stacklevel=2)
        return True
    msg = (f"Stage-1 tile list overflowed k_max={k_max}; entries past the "
           f"capacity were dropped (clamped){suffix}. Raise "
           f"StreamConfig.k_max or register the scene with probe_cameras "
           f"to measure a sufficient bound.")
    if policy is OverflowPolicy.RAISE:
        raise StreamOverflowError(msg)
    warnings.warn(msg, StreamOverflowWarning, stacklevel=2)
    return True


def measure_k_max(scene: GaussianScene, cameras, *,
                  grid: GridConfig = GridConfig(),
                  cap: Optional[int] = None) -> int:
    """k_max from the Stage-1 survivor histogram over a camera probe set:
    the longest per-tile survivor list over all probes, rounded up to a
    power of two and bounded by `cap`. Each camera carries its own
    resolution; the (T, N) Stage-1 mask is counted one tile chunk at a
    time, as the compaction does."""
    from repro_torch.core.raster import COMPACT_CHUNK_ELEMS
    cameras = list(cameras)
    if not cameras:
        raise ValueError("measure_k_max needs at least one probe camera "
                         "(an empty probe set would measure k_max=1 and "
                         "clamp every tile list)")
    longest = 1
    for cam in cameras:
        g = grid.with_resolution(cam.height, cam.width).make()
        proj = project(scene, cam)
        t, n = g.num_tiles, proj.depth.shape[0]
        origins = g.tile_origins(proj.depth.device)
        chunk = tile_chunk(t, n, COMPACT_CHUNK_ELEMS)
        for s in range(0, t, chunk):
            counts = aabb_mask(proj, origins[s:s + chunk], g.tile).sum(dim=1)
            longest = max(longest, int(counts.max()))
    k = next_pow2(longest)
    return min(k, cap) if cap is not None else k


def cat_mask_elems(grid: TileGrid, n: int, k_max: int, dataflow: str) -> int:
    """Boolean elements the CAT stage materializes per pass (the Stage-1 +
    CAT masks, 1 byte each): dense (S + M)·N, stream T·K·(Sp + Mt), which
    does not depend on the Gaussian count."""
    if dataflow == "dense":
        return (grid.num_subtiles + grid.num_minitiles) * n
    if dataflow == "stream":
        return grid.num_tiles * k_max * (grid.subtiles_per_tile
                                         + grid.minitiles_per_tile)
    raise ValueError(dataflow)
