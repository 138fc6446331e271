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

`RenderPlan.shard` (`ShardConfig`, default one shard) splits the
post-Stage-1 tail over the tile axis of the active mesh
(`repro_torch.distributed.sharding.use_mesh`): shard k runs the CTU and
the blend of rows k·T/S..(k+1)·T/S-1 of every frame and pass on its mesh
device (one K1 and one K2 launch a pass per shard), the rows are gathered
once, and the counters are computed on the gathered integer hits and
per-tile floats by the single-device expressions, so the sharded frame is
bit-identical to the single-device one. `render_tile_subset` re-renders
any rows alone (shard-drop recovery, `repro_torch.distributed.fault`).

`RenderPlan.dataflow` selects how the hierarchy materializes between
Stage 1 and the CTU: "stream" (the default: compact first, CTU on
survivors only, O(T·k_max·16) masks) or "dense" (the O(regions·N) parity
oracle, which every stream quantity must match). The AABB (vanilla 3DGS)
and OBB (GSCore) baselines compact their own dense tile masks.
"""
from __future__ import annotations

import dataclasses
import enum
import math
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
class ShardConfig:
    """Tile-axis device sharding of the post-Stage-1 pipeline.

    With tile_shards > 1 the plan partitions the per-tile survivor streams
    (`TileStream` rows, every spill pass) into `tile_shards` contiguous
    blocks over the mesh axis the logical `axis` resolves to
    (`distributed.sharding.resolve`; "tile" -> the `model` mesh axis) and
    runs CTU + blend per shard on that shard's device, gathering exactly
    once before the finalize: the multi-PRTU parallel datapath of the
    paper, mapped onto devices. Tiles are independent after compaction, so
    the sharded render is bit-identical to the single-device path on
    images, `entry_alive` and every counter.

    Requirements: the stream dataflow with the CAT method, a tile count
    divisible by tile_shards, and an active mesh
    (`distributed.sharding.use_mesh` or
    `serving.RenderEngine(shard_tiles=...)`) whose resolved axis has size
    tile_shards. Part of the plan's value, so the serving plan cache keys
    on it like every other stage config.
    """
    tile_shards: int = 1
    axis: str = "tile"

    def __post_init__(self):
        if self.tile_shards < 1:
            raise ValueError(
                f"tile_shards must be >= 1, got {self.tile_shards}")


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
class StageSpec:
    """Introspection record for one plan stage."""
    name: str
    backend: str
    description: str


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """An executable, hashable composition of the render stages. dataflow
    is "stream" (survivor streams, the default) or "dense" (the parity
    oracle). shard (default one shard) is the tile-axis sharding of the
    post-Stage-1 tail (`ShardConfig`). lod (default None) is the optional
    LOD stage's `repro_torch.lod.LODConfig`, read only by
    `render_lod_with_stats`. Tensors stay on the device of the scene and
    camera they are given; a sharded plan's shards run on the active
    mesh's devices and gather back to that device."""
    grid: GridConfig = GridConfig()
    test: TestConfig = TestConfig()
    stream: StreamConfig = StreamConfig()
    raster: RasterConfig = RasterConfig()
    dataflow: str = "stream"                  # stream | dense
    shard: ShardConfig = ShardConfig()
    lod: Optional["LODConfig"] = None

    def __post_init__(self):
        if self.dataflow not in ("stream", "dense"):
            raise ValueError(f"unknown dataflow {self.dataflow!r} "
                             "(expected 'stream' or 'dense')")
        if self.shard.tile_shards > 1:
            if self.dataflow != "stream" or self.test.method != "cat":
                raise ValueError(
                    "tile sharding requires the stream dataflow with the "
                    f"'cat' method (got dataflow={self.dataflow!r}, "
                    f"method={self.test.method!r}) — the dense oracle and "
                    "the baselines materialize (regions, N) masks that the "
                    "per-tile partitioning cannot split")

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
        return H.stream_entry_test_frames(
            fold, [ps.proj for ps in pss], pss[0].grid,
            [ts.lists for ts in tss], [ts.valid for ts in tss],
            [ts.overflow for ts in tss], self.test.mode,
            self.test.precision, self.test.spiky_threshold,
            cat_fn=self._cat_fn())

    def _cat_fn(self):
        """The entry CAT of the "cuda" backend (K1), None for "torch"."""
        if self.test.backend != "cuda":
            return None
        from repro_torch.kernels import ops as kops
        return kops.entry_cat_fn(self.test.mode, self.test.precision,
                                 self.test.spiky_threshold)

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
        n_pass = len(houts[0])
        note = _BlendNote(tracer)
        state, alive_parts, kparts, kb_total = None, [], [], 0
        for i in range(n_pass):
            lists, valid, masks = zip(*((h[i].lists, h[i].valid,
                                         h[i].entry_mini_mask)
                                        for h in houts))
            with tracer.span("blend", {"pass": i,
                                       "backend": self._blend_backend()}
                             ) as sp:
                state, alive, kproc, kb = self._blend_step(
                    fold, grid, fold.ids(lists), fold.cat(valid),
                    fold.cat(masks), state)
                note(sp, [state], [alive])
            alive_parts.append(alive)
            kparts.append(kproc)
            kb_total += kb
        return self._finalize_blend_frames(
            grid, fold.frames, state, alive_parts, kparts, kb_total,
            [h[0].overflow for h in houts], houts[0][0].lists.shape[1])

    def _blend_backend(self) -> str:
        return "cuda" if self.raster.fused else "torch"

    def _blend_step(self, fold: H.FrameFold, grid: TileGrid, ids, valid,
                    masks, state):
        """One pass's blend over the fold's rows, resuming from `state`
        (None on the first pass): one K2 launch when fused, else the
        `raster.blend_pass` fold. Returns (state, entry_alive (B·t, K),
        kblocks_processed (B·t,) or None, kblocks_total). Either state
        ends with its processed and blended maps."""
        if self.raster.fused:
            from repro_torch.kernels import ops as kops
            fb = kops.blend_fused_rows(fold, grid, ids, valid, masks, state)
            return ((fb.trans, fb.rgb, fb.processed, fb.blended),
                    fb.entry_alive, fb.kblocks_processed, fb.kblocks_total)
        if state is None:
            state = raster.init_blend_state(fold.frames * fold.tiles,
                                            grid.tile ** 2, ids.device)
        state, alive = raster.blend_pass(fold.proj, grid, ids, valid, masks,
                                         state,
                                         tile_origins=fold.tile_origins)
        return state, alive, None, 0

    def _finalize_blend_frames(self, grid: TileGrid, frames: int, state,
                               alive_parts, kparts, kb_total, overflows,
                               k: int):
        """Per-frame (RenderOut, blend counters, per-pass entry_alive list)
        from the carried state of B frames' full rows (frame b's tiles at
        rows b·T..(b+1)·T-1) after the last of the passes of k slots."""
        n_pass = len(alive_parts)
        bg = self.raster.background
        if self.raster.fused:
            from repro_torch.kernels import ops as kops
            results = kops.finalize_fused_frames(
                grid, frames, state, bg, overflows, alive_parts, kparts,
                kb_total)
        else:
            device = state.trans.device
            entry_alive = torch.cat(alive_parts, dim=1)
            t = grid.num_tiles
            results = []
            for b in range(frames):
                rows = slice(b * t, (b + 1) * t)
                out = raster.finalize_blend(
                    grid, raster.BlendState(*(x[rows] for x in state)), bg,
                    overflows[b], entry_alive[rows])
                # The unfused sweep always walks every padded list slot.
                results.append((out, dict(swept_per_pixel=torch.tensor(
                    float(n_pass * k), device=device))))
        out_frames = []
        for out, counters in results:
            counters = dict(counters)
            counters["processed_per_pixel"] = out.processed_per_pixel.mean()
            counters["blended_per_pixel"] = out.blended_per_pixel.mean()
            out_frames.append((out, counters, [
                out.entry_alive[:, i * k:(i + 1) * k]
                for i in range(n_pass)]))
        return out_frames

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
                         fused=self.raster.fused,
                         tile_shards=self.shard.tile_shards,
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
        fold, then the per-frame counter merge and finalize. With
        `ShardConfig.tile_shards > 1` the tail runs tile-sharded over the
        active mesh (`_render_streams_sharded`, bit-identical output).
        Returns one (RenderOut, counters dict) per frame."""
        if self.shard.tile_shards > 1:
            return self._render_streams_sharded(pss, streams, tracer, root)
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
        blended = self._blend_frames(fold, grid, houts, tracer)
        return self._finish_frames(
            pss, streams, counters, blended,
            lambda b, p, alive: self._effective_counters(
                pss[b], streams[b][p], houts[b][p], alive), tracer, root)

    def _finish_frames(self, pss, streams, counters, blended, effective,
                       tracer, root, extra=None):
        """The shared finalize of B frames: blend counters, the
        termination-aware counters (effective(b, pass, entry_alive)), the
        spill pass count and `extra(b)`'s counters join each frame's CTU
        counters under the `finalize` span. Returns one (RenderOut,
        counters) per frame."""
        cat = self.test.method == "cat"
        frames = []
        with tracer.span("finalize") as sp:
            for b, (ps, ts, c, (out, blend_counters, alive_parts)) in \
                    enumerate(zip(pss, streams, counters, blended)):
                if cat:
                    c["cat_mask_bytes"] = torch.tensor(
                        float(cat_mask_elems(ps.grid, ps.proj.depth.shape[0],
                                             self.stream.k_max,
                                             self.dataflow)),
                        device=ps.proj.depth.device)
                c.update(blend_counters)
                if cat:
                    eff: dict = {}
                    for p, alive in enumerate(alive_parts):
                        for key, v in effective(b, p, alive).items():
                            eff[key] = v if key not in eff else eff[key] + v
                    c.update(eff)
                # Passes that actually carried entries (>= 1 even on an
                # empty frame).
                used = sum(int(x.valid.any()) for x in ts)
                c["spill_passes"] = torch.tensor(
                    float(max(used, 1)), device=ps.proj.depth.device)
                if extra is not None:
                    c.update(extra(b))
                frames.append((out, c))
            tracer.block(frames)
            if tracer.enabled:
                sp.set(spill_passes=_frame_mean(frames, "spill_passes"),
                       overflow=any(bool(o.overflow) for o, _ in frames))
                if self.shard.tile_shards > 1:
                    sp.set(tile_shards=self.shard.tile_shards, sharded=True)
                if root is not None:
                    root.set(**{k: _frame_mean(frames, k) for k in
                                ("processed_per_pixel", "blended_per_pixel",
                                 "vru_pairs", "spill_passes")
                                if k in frames[0][1]
                                and frames[0][1][k].dim() == 0})
        return frames

    # -- tile-row primitives (one shard's body = a row subset) --------------

    def _ctu_tile_rows(self, fold: H.FrameFold, grid: TileGrid, lists,
                       valid):
        """CTU on the fold's rows: per-entry CAT mask and hit counts.

        The per-shard body of the tile-sharded CTU and the row kernel of
        `render_tile_subset`: the same evaluation the single-device CTU
        runs on the full grid (`hierarchy.entry_test_rows`, one K1 launch
        on the "cuda" backend), on the rows whose origins the fold holds.
        lists, valid: each frame's rows. Returns (entry_mini (B·t, K, Mt),
        sub_hits (B·t, K), mini_hits (B·t, K))."""
        _, mini, sub_hits, mini_hits = H.entry_test_rows(
            fold, grid, lists, valid, self.test.mode, self.test.precision,
            self.test.spiky_threshold, cat_fn=self._cat_fn())
        return mini, sub_hits, mini_hits

    def _blend_tile_rows(self, fold: H.FrameFold, grid: TileGrid,
                         pass_rows):
        """Blend fold over the spill passes on the fold's rows.

        pass_rows: [(lists, valid, entry_mini), ...] per pass, folded rows.
        Returns (state, alive_parts, kblock_parts): the fused (trans, rgb,
        processed, blended) carry or the unfused `raster.BlendState`, the
        per-pass (B·t, K) entry_alive and, fused, the per-pass (B·t,)
        kblocks_processed (None unfused). Tiles blend independently, so
        these rows equal the same rows of the full-grid fold exactly."""
        state, alive, kproc = None, [], []
        for lists, valid, mini in pass_rows:
            state, a, kp, _ = self._blend_step(fold, grid, lists, valid,
                                               mini, state)
            alive.append(a)
            kproc.append(kp)
        return state, alive, (kproc if self.raster.fused else None)

    def _render_streams_sharded(self, pss, streams, tracer, root=None):
        """Tile-sharded post-Stage-1 tail over the active mesh.

        The per-tile survivor streams of every frame and spill pass are
        partitioned into `shard.tile_shards` contiguous row blocks over the
        mesh axis the logical shard axis resolves to. Shard k runs the CTU
        and the blend of its rows on its device (one K1 and one K2 launch a
        pass), emitting its blend-state rows, entry_alive rows, integer
        per-entry hit counts and, fused, per-tile K-block counts. One
        gather (`.to` the frames' device, then `torch.cat`: integers and
        independent per-tile floats move exactly) feeds the finalize the
        single-device path runs, and the counters are evaluated by the
        same expressions on the gathered hit counts
        (`hierarchy.stream_entry_counters`); no float is summed per shard.
        That is why the sharded render is bit-identical on images,
        entry_alive and every counter. The frames' `ctu[pass=i]` and
        `blend[pass=i]` spans each cover every shard's launch of the pass
        and carry `sharded` and `tile_shards`.

        With a data axis in the mesh, the shards run on its first row
        (the serving engine splits a batch over the data axis and enters
        each row's sub-mesh). Eager PyTorch has no counterpart of the
        reference's "must run under jax.jit" requirement.
        """
        from repro_torch.distributed import sharding as dshard

        grid = pss[0].grid
        s = self.shard.tile_shards
        mesh = dshard.active_mesh()
        if mesh is None:
            raise RuntimeError(
                f"RenderPlan has shard.tile_shards={s} but no active mesh; "
                "wrap the render in distributed.sharding.use_mesh(mesh) "
                "(serving.RenderEngine does this when constructed with "
                "shard_tiles)")
        axes = dshard.resolve((self.shard.axis,), mesh)[0]
        axes_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        axis_size = math.prod(mesh.shape[a] for a in axes_tuple)
        if axis_size != s:
            raise ValueError(
                f"shard.tile_shards={s} but the mesh's "
                f"{self.shard.axis!r} axis ({axes_tuple} on mesh "
                f"{dict(mesh.shape)}) has size {axis_size}")
        if grid.num_tiles % s != 0:
            raise ValueError(
                f"num_tiles={grid.num_tiles} is not divisible by "
                f"tile_shards={s}")

        batch, n_pass = len(pss), len(streams[0])
        t = grid.num_tiles // s
        primary = pss[0].proj.depth.device
        # The devices along the shard axis, at index 0 of the other one.
        devices = (mesh.devices[0] if axes_tuple == ("model",)
                   else tuple(row[0] for row in mesh.devices))
        fold = H.fold_frames([ps.proj for ps in pss], grid)
        origins = grid.tile_origins(primary)
        blocks = [slice(k * t, (k + 1) * t) for k in range(s)]
        shards = [fold.on(dev, origins[blk])
                  for dev, blk in zip(devices, blocks)]
        # rows[k][p]: shard k's (lists, valid) of every frame in pass p.
        rows = [[([st[p].lists[blk].to(dev) for st in streams],
                  [st[p].valid[blk].to(dev) for st in streams])
                 for p in range(n_pass)]
                for dev, blk in zip(devices, blocks)]

        ctu = [[None] * n_pass for _ in range(s)]
        for p in range(n_pass):
            with tracer.span("ctu", {"pass": p, "sharded": True,
                                     "tile_shards": s}):
                for k, (dev, sf) in enumerate(zip(devices, shards)):
                    with dshard.on_device(dev):
                        ctu[k][p] = self._ctu_tile_rows(sf, grid, *rows[k][p])
                tracer.block(ctu)
        note = _BlendNote(tracer)
        states = [None] * s
        alive = [[None] * n_pass for _ in range(s)]
        kproc = [[None] * n_pass for _ in range(s)]
        kb_total = 0
        for p in range(n_pass):
            with tracer.span("blend", {"pass": p, "sharded": True,
                                       "tile_shards": s,
                                       "backend": self._blend_backend()}
                             ) as sp:
                for k, (dev, sf) in enumerate(zip(devices, shards)):
                    lists, valid = rows[k][p]
                    with dshard.on_device(dev):
                        states[k], alive[k][p], kproc[k][p], kb = \
                            self._blend_step(sf, grid, sf.ids(lists),
                                             sf.cat(valid), ctu[k][p][0],
                                             states[k])
                kb_total += kb
                note(sp, states, [alive[k][p] for k in range(s)])

        # The single gather: each shard's rows back to the frames' device,
        # frame by frame in tile order.
        def gather(parts):
            return torch.cat([x.to(primary).view(batch, t, *x.shape[1:])
                              for x in parts], dim=1).flatten(0, 1)

        state = tuple(gather(f) for f in zip(*states))
        if not self.raster.fused:
            state = raster.BlendState(*state)
        alive_parts = [gather([a[p] for a in alive]) for p in range(n_pass)]
        kparts = ([gather([kp[p] for kp in kproc]) for p in range(n_pass)]
                  if self.raster.fused else None)
        sub_hits = [gather([c[p][1] for c in ctu]) for p in range(n_pass)]
        mini_hits = [gather([c[p][2] for c in ctu]) for p in range(n_pass)]

        counters = []
        for b, (ps, st) in enumerate(zip(pss, streams)):
            r = slice(b * grid.num_tiles, (b + 1) * grid.num_tiles)
            pass_c = [H.stream_entry_counters(
                ps.proj, grid, st[p].lists, st[p].valid, sub_hits[p][r],
                mini_hits[p][r], self.test.mode, self.test.spiky_threshold)
                for p in range(n_pass)]
            c = dict(pass_c[0])
            for pc in pass_c[1:]:
                for key in H.ADDITIVE_COUNTER_KEYS:
                    c[key] = c[key] + pc[key]
            counters.append(c)
        blended = self._finalize_blend_frames(
            grid, batch, state, alive_parts, kparts, kb_total,
            [st[0].overflow for st in streams], streams[0][0].lists.shape[1])

        def effective(b, p, alive):
            r = slice(b * grid.num_tiles, (b + 1) * grid.num_tiles)
            return self._effective_counters_from_hits(
                pss[b].proj, streams[b][p].lists, sub_hits[p][r],
                mini_hits[p][r], alive)

        def occupancy(b):
            # How evenly the survivor entries split over the shards
            # (contiguous tile blocks): max == min is a balanced frame.
            valid = torch.stack([ts.valid for ts in streams[b]])
            per_shard = valid.view(n_pass, s, t, -1).sum(dim=(0, 2, 3))
            f32 = torch.float32
            return dict(
                tile_shards=torch.tensor(float(s), dtype=f32,
                                         device=primary),
                shard_entries_max=per_shard.max().to(f32),
                shard_entries_min=per_shard.min().to(f32))

        return self._finish_frames(pss, streams, counters, blended,
                                   effective, tracer, root, extra=occupancy)

    def render_tile_subset(self, scene: GaussianScene, camera, tile_ids):
        """Single-device re-render of a subset of tiles (by row index).

        The shard-recovery path: when a tile shard is lost mid-frame, the
        survivors re-run exactly the lost rows. Preprocess and Stage 1 are
        recomputed (they were never sharded), then the CTU and the blend
        run on the selected rows only, with their tile origins. Tiles are
        independent, so each returned row equals the same row of the full
        render bit for bit, which is what lets
        `distributed.fault.render_with_shard_recovery` splice them into the
        healthy frame under a parity gate.

        tile_ids: (B,) int tile indices. Returns a dict of per-tile rows:
        image (B, P, 3), alpha (B, P), processed (B, P), blended (B, P)
        (floats, after the background and the finalize), entry_alive
        (B, n_passes·K).
        """
        if self.dataflow != "stream" or self.test.method != "cat":
            raise ValueError(
                "render_tile_subset requires the stream dataflow with the "
                "'cat' method (the row-wise CTU has no dense/baseline form)")
        ps = self.preprocess(scene, camera)
        streams = self.stage1_compact(ps)
        grid = ps.grid
        device = ps.proj.depth.device
        tile_ids = torch.as_tensor(tile_ids, device=device).long()
        fold = H.fold_frames([ps.proj], grid).on(
            device, grid.tile_origins(device)[tile_ids])
        pass_rows = []
        for ts in streams:
            lists, valid = ts.lists[tile_ids], ts.valid[tile_ids]
            mini, _, _ = self._ctu_tile_rows(fold, grid, [lists], [valid])
            pass_rows.append((lists, valid, mini))
        state, alive, _ = self._blend_tile_rows(fold, grid, pass_rows)
        entry_alive = torch.cat(alive, dim=1)
        bg = self.raster.background
        if self.raster.fused:
            trans, rgb, processed, blended = state
            acc = 1.0 - trans
            rgb = rgb + bg * trans[:, :, None]
        else:
            rgb = state.rgb + bg * (1.0 - state.acc)[..., None]
            acc = state.acc
            processed = state.processed.to(torch.float32)
            blended = state.blended.to(torch.float32)
        return dict(image=rgb, alpha=acc, processed=processed,
                    blended=blended, entry_alive=entry_alive)

    # -- introspection ------------------------------------------------------

    def stages(self) -> tuple[StageSpec, ...]:
        """The plan's stage sequence (name, backend, one-line description)."""
        test_be = self.test.backend if self.test.method == "cat" else "torch"
        ctu_desc = {
            "cat": f"mini-tile CAT on {self.dataflow} entries",
            "obb": "sub-tile OBB gathered at entries",
            "aabb": "no fine test (whole tile list blends)",
        }[self.test.method]
        passes = (f" x {self.n_passes} spill passes"
                  if self.n_passes > 1 else "")
        return (
            StageSpec("preprocess", "torch", "projection + 3σ footprints"),
            StageSpec("stage1_compact", "torch",
                      f"Stage-1 {self.test.method} + depth sort + "
                      f"k_max={self.stream.k_max} compaction{passes} "
                      f"({self.stream.overflow.value} on overflow)"),
            StageSpec("ctu", test_be, ctu_desc),
            StageSpec("blend", self._blend_backend(),
                      "fused in-kernel early termination" if self.raster.fused
                      else "pure-torch differentiable sweep"),
        )

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

    def _effective_counters_from_hits(self, proj: Projected, lists,
                                      sub_hits, mini_hits,
                                      entry_alive) -> dict:
        """Stream-dataflow effective counters from per-entry hit counts
        ((T, K) ints). `_effective_counters` reduces the per-entry masks
        to them and the tile-sharded path gathers them from the shards:
        one expression set, so the two paths stay bit-identical."""
        idx = lists.clamp_min(0).long()                          # (T, K)
        prs = self._prs_per_subtile(proj).double()[idx]
        f32 = torch.float32
        return dict(
            ctu_pairs_eff=(sub_hits * entry_alive).sum().to(f32),
            ctu_prs_eff=H.exact_f32(sub_hits * prs * entry_alive),
            vru_pairs_eff=(mini_hits * entry_alive).sum().to(f32),
            ctu_stream_len=entry_alive.sum().to(f32),
        )

    def _effective_counters(self, ps: ProjectedScene, ts: TileStream,
                            hout: H.StreamHierarchyOut, entry_alive) -> dict:
        """Termination-aware CTU/VRU workload: for each list entry processed
        before its tile terminated, one PR batch per hit sub-tile and one
        mini-tile blend per CAT-passing mini-tile. On the stream dataflow
        the per-entry masks are those quantities; on the dense oracle the
        sub-tile and mini-tile bits are gathered at the entries from the
        full masks through the tile's image-global region ids."""
        if self.dataflow == "stream":
            sub = hout.entry_sub_mask                            # (T, K, Sp)
            mini = hout.entry_mini_mask                          # (T, K, Mt)
        else:
            idx = hout.lists.clamp_min(0).long()                 # (T, K)
            device = idx.device
            sub = ts.dense.subtile_mask[
                ps.grid.global_subtile_ids(device)[:, None, :],
                idx[:, :, None]]
            mini = ts.dense.minitile_mask[
                ps.grid.global_minitile_ids(device)[:, None, :],
                idx[:, :, None]]
        return self._effective_counters_from_hits(
            ps.proj, hout.lists, sub.sum(dim=-1), mini.sum(dim=-1),
            entry_alive)


class _BlendNote:
    """The `blend[pass=i]` span's processed/blended deltas and live
    entries, from one pass's blend states and entry_alive (one of each per
    shard). Sums are float64 over integer counts, so a sharded pass reports
    what the single-device pass does."""

    def __init__(self, tracer):
        self.tracer = tracer
        self.prev = [0.0, 0.0]

    def __call__(self, sp, states, alives):
        tracer = self.tracer
        tracer.block((states, alives))
        if not tracer.enabled:
            return
        proc = sum(float(st[-2].sum(dtype=torch.float64)) for st in states)
        bl = sum(float(st[-1].sum(dtype=torch.float64)) for st in states)
        sp.set(processed_delta=proc - self.prev[0],
               blended_delta=bl - self.prev[1],
               entries_alive=float(sum(float(a.sum()) for a in alives)))
        self.prev = [proc, bl]


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
                 shard: Optional[ShardConfig] = None,
                 lod: Optional["LODConfig"] = None):
        self.plan = RenderPlan(
            grid=grid if grid is not None else GridConfig(),
            test=test if test is not None else TestConfig(),
            stream=stream if stream is not None else StreamConfig(),
            raster=raster if raster is not None else RasterConfig(),
            dataflow=dataflow,
            shard=shard if shard is not None else ShardConfig(), lod=lod)

    @classmethod
    def from_plan(cls, plan: RenderPlan) -> "Renderer":
        r = cls.__new__(cls)
        r.plan = plan
        return r

    def replace(self, **kw) -> "Renderer":
        """New Renderer with plan fields replaced (grid/test/stream/raster/
        dataflow/shard/lod)."""
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


def as_plan(obj) -> RenderPlan:
    """Normalize Renderer | RenderPlan | legacy RenderConfig to a plan."""
    if isinstance(obj, RenderPlan):
        return obj
    if isinstance(obj, Renderer):
        return obj.plan
    if hasattr(obj, "to_plan"):               # legacy pipeline.RenderConfig
        return obj.to_plan()
    raise TypeError(f"cannot build a RenderPlan from {type(obj).__name__}")


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
