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
from typing import Optional

import torch

from repro_torch.core.gaussians import GaussianScene, Projected, project, \
    classify_spiky
from repro_torch.core.culling import TileGrid, aabb_mask, tile_divisor_chunk
from repro_torch.core.cat import SamplingMode
from repro_torch.core import hierarchy as H
from repro_torch.core import raster
from repro_torch.core.precision import PrecisionScheme, MIXED

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
    oracle). Tensors stay on the device of the scene and camera they are
    given."""
    grid: GridConfig = GridConfig()
    test: TestConfig = TestConfig()
    stream: StreamConfig = StreamConfig()
    raster: RasterConfig = RasterConfig()
    dataflow: str = "stream"                  # stream | dense

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
        cat_fn = None
        if self.test.backend == "cuda":
            from repro_torch.kernels import ops as kops
            cat_fn = kops.entry_cat_fn(self.test.mode, self.test.precision,
                                       self.test.spiky_threshold)
        return H.stream_entry_test(
            ps.proj, ps.grid, ts.lists, ts.valid, ts.overflow,
            self.test.mode, self.test.precision, self.test.spiky_threshold,
            cat_fn=cat_fn)

    def _blend_passes(self, ps: ProjectedScene, houts):
        """Blend the spill passes front to back from one carried state.
        Returns (RenderOut, blend counters, per-pass entry_alive list)."""
        proj, grid = ps.proj, ps.grid
        counters: dict = {}
        if self.raster.fused:
            from repro_torch.kernels import ops as kops
            out, fused_counters = kops.render_tiles_fused_passes(
                proj, grid,
                [(h.lists, h.valid, h.entry_mini_mask) for h in houts],
                self.raster.background, houts[0].overflow)
            counters.update(fused_counters)
            k = houts[0].lists.shape[1]
            alive_parts = [out.entry_alive[:, i * k:(i + 1) * k]
                           for i in range(len(houts))]
        else:
            state = raster.init_blend_state(grid.num_tiles, grid.tile ** 2,
                                            proj.depth.device)
            alive_parts = []
            for h in houts:
                state, alive = raster.blend_pass(
                    proj, grid, h.lists, h.valid, h.entry_mini_mask, state)
                alive_parts.append(alive)
            out = raster.finalize_blend(grid, state, self.raster.background,
                                        houts[0].overflow,
                                        torch.cat(alive_parts, dim=1))
            # The unfused sweep always walks every padded list slot.
            counters["swept_per_pixel"] = torch.tensor(
                float(sum(h.lists.shape[1] for h in houts)),
                device=proj.depth.device)
        counters["processed_per_pixel"] = out.processed_per_pixel.mean()
        counters["blended_per_pixel"] = out.blended_per_pixel.mean()
        return out, counters, alive_parts

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
        ps = self.preprocess(scene, camera)
        streams = self.stage1_compact(ps)
        out, counters = self._render_streams(ps, streams)
        if enforce:
            enforce_overflow_policy(out.overflow, self.stream.overflow,
                                    k_max=self.stream.k_max,
                                    n_passes=self.n_passes)
        return out, counters

    def render(self, scene: GaussianScene, camera) -> raster.RenderOut:
        out, _ = self.render_with_stats(scene, camera)
        return out

    def _render_streams(self, ps: ProjectedScene, streams):
        """The post-Stage-1 tail: CTU per pass, counter merge, blend fold,
        finalize. Returns (RenderOut, counters dict)."""
        houts = [self.ctu(ps, ts) for ts in streams]
        counters = self._merge_hout_counters(houts)
        device = ps.proj.depth.device
        cat = self.test.method == "cat"
        if cat:
            counters["cat_mask_bytes"] = torch.tensor(
                float(cat_mask_elems(ps.grid, ps.proj.depth.shape[0],
                                     self.stream.k_max, self.dataflow)),
                device=device)
        out, blend_counters, alive_parts = self._blend_passes(ps, houts)
        counters.update(blend_counters)
        if cat:
            eff: dict = {}
            for ts, hout, alive in zip(streams, houts, alive_parts):
                for key, v in self._effective_counters(ps, ts, hout,
                                                       alive).items():
                    eff[key] = v if key not in eff else eff[key] + v
            counters.update(eff)
        # Passes that actually carried entries (>= 1 even on an empty frame).
        used = sum(int(h.valid.any()) for h in houts)
        counters["spill_passes"] = torch.tensor(float(max(used, 1)),
                                                device=device)
        return out, counters

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
                 dataflow: str = "stream"):
        self.plan = RenderPlan(
            grid=grid if grid is not None else GridConfig(),
            test=test if test is not None else TestConfig(),
            stream=stream if stream is not None else StreamConfig(),
            raster=raster if raster is not None else RasterConfig(),
            dataflow=dataflow)

    @classmethod
    def from_plan(cls, plan: RenderPlan) -> "Renderer":
        r = cls.__new__(cls)
        r.plan = plan
        return r

    def replace(self, **kw) -> "Renderer":
        """New Renderer with plan fields replaced (grid/test/stream/raster/
        dataflow)."""
        return Renderer.from_plan(dataclasses.replace(self.plan, **kw))

    def render_with_stats(self, scene: GaussianScene, camera):
        return self.plan.render_with_stats(scene, camera)

    def __repr__(self):
        return f"Renderer({self.plan!r})"


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
        chunk = tile_divisor_chunk(t, n, COMPACT_CHUNK_ELEMS)
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
