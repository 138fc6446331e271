"""The port's frame-coherent incremental rendering (`core/coherence.py`)
against the JAX reference, at 64 px on scenes of 300-400 Gaussians drawn
by the reference's `random_scene` and converted.

Stage parity takes the reference's own `Projected` as input: the port's
tile-cover rectangles and fingerprints equal the reference's exactly, and
the count lane equals the port's Stage-1 membership. The id hash lanes
equal the reference's uint32 lanes up to n = 2**19 (fault F3: torch has no
uint32 arithmetic on the CPU, so the port builds them with numpy).

The headline contract, as in `test_coherence.py`: along a smooth
trajectory with a jump-cut, every incremental frame is bit-identical to a
cold-cache (full recompaction) render of the port across {CLAMP, SPILL} x
{fused False, True}, and the smooth segment really reuses tiles. Against
the reference's `render_incremental`, the cached lists, valid bits and
the three coherence counters are equal exactly; images are held at the
2e-4 of `test_torch_render.py`, because the reference's programs are
jitted (fault F4). The fallbacks behave as the reference's, and the
re-sort keeps the order of ties (fault F2).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        RasterConfig as JRaster, RenderPlan as JPlan,
                        StreamConfig as JStream, TestConfig as JTest)
from repro.core import coherence as jcoh
from repro.core import gaussians as jgaussians
from repro.core import orbit_camera as jorbit, project as jproject
from repro.core import random_scene as jrandom_scene
from repro.core.culling import TileGrid as JTileGrid
from repro.core.precision import MIXED as J_MIXED
from repro.serving.workloads import trajectory_cameras as jtrajectory

from repro_torch import convert
from repro_torch.core import (MIXED, CoherenceConfig, GridConfig,
                              OverflowPolicy, RasterConfig, Renderer,
                              RenderPlan, StreamConfig, TestConfig,
                              camera_delta, orbit_camera, render_incremental,
                              tile_fingerprints)
from repro_torch.core import coherence as coh
from repro_torch.core.culling import TileGrid, aabb_mask
from repro_torch.core.raster import depth_order
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.workloads import trajectory_cameras

SCENE_KW = dict(scale_range=(-3.3, -2.7), stretch=3.0,
                opacity_range=(-1.0, 3.0))
RES = 64                         # 4x4 = 16 tiles
STEP = 0.004                     # smooth-orbit step that actually reuses
COHERENCE_KEYS = {"tiles_reused", "tiles_recompacted", "full_recompactions"}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Small tensors: few intra-op threads keep torch's workers from
    competing with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    names = ([f.name for f in dataclasses.fields(obj)]
             if dataclasses.is_dataclass(obj) else obj._fields)
    return {n: np.asarray(getattr(obj, n)) for n in names}


@functools.lru_cache(maxsize=None)
def ref_scene(seed: int, n: int = 300, **kw):
    """The reference's seeded scene, and its conversion into the port."""
    scene = jrandom_scene(jax.random.PRNGKey(seed), n, **(kw or SCENE_KW))
    return scene, convert.scene_from_numpy(fields(scene))


def make_plan(policy: str, fused: bool = False) -> RenderPlan:
    if policy == "spill":
        stream = StreamConfig(k_max=32, overflow=OverflowPolicy.SPILL,
                              max_spill_passes=8)
    else:
        stream = StreamConfig(k_max=256)     # generous: CLAMP never trips
    return RenderPlan(grid=GridConfig(height=RES, width=RES),
                      test=TestConfig(method="cat", precision=MIXED,
                                      backend="cuda" if fused else "torch"),
                      stream=stream, raster=RasterConfig(fused=fused))


def make_ref_plan(policy: str) -> JPlan:
    if policy == "spill":
        stream = JStream(k_max=32, overflow=JPolicy.SPILL,
                         max_spill_passes=8)
    else:
        stream = JStream(k_max=256)
    return JPlan(grid=JGrid(height=RES, width=RES),
                 test=JTest(method="cat", precision=J_MIXED),
                 stream=stream, raster=JRaster(fused=False))


def assert_frames_equal(out_i, c_i, out_f, c_f):
    """Image, alpha, work maps, entry_alive, overflow and every counter
    outside the three coherence keys, bit for bit."""
    for name in out_f._fields:
        assert torch.equal(getattr(out_i, name), getattr(out_f, name)), name
    assert set(c_i) == set(c_f)
    for k in set(c_f) - COHERENCE_KEYS:
        assert torch.equal(c_i[k], c_f[k]), k


# ---------------------------------------------------------------------------
# fingerprints, against the reference's stage on the reference's Projected
# ---------------------------------------------------------------------------

def test_cover_rects_and_fingerprints_match_reference():
    """tile_cover_rects and tile_fingerprints equal the reference's exactly
    at several poses (the reference's `Projected` into both); the count
    lane is the port's Stage-1 membership, the aabb_mask row sums; the
    same pose twice gives the same fingerprints."""
    jscene, _ = ref_scene(9, 400)
    grid, jgrid = TileGrid(RES, RES), JTileGrid(RES, RES)
    for theta in (0.0, 0.4, 2.1, 5 * STEP):
        jproj = jproject(jscene, jorbit(theta, RES, RES))
        proj = convert.projected_from_numpy(fields(jproj))
        for want, got in zip(jcoh.tile_cover_rects(jproj, jgrid),
                             coh.tile_cover_rects(proj, grid)):
            assert got.dtype in (torch.int32, torch.bool)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        jfp, jcounts = jcoh.tile_fingerprints(jproj, jgrid)
        fp, counts = tile_fingerprints(proj, grid)
        assert fp.dtype == torch.int64 and counts.dtype == torch.int32
        np.testing.assert_array_equal(fp.numpy(),
                                      np.asarray(jfp).astype(np.int64))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        members = aabb_mask(proj, grid.tile_origins(), grid.tile).sum(dim=1)
        assert torch.equal(counts, members.to(torch.int32))
        assert int(counts.sum()) > 0
        again, _ = tile_fingerprints(proj, grid)
        assert torch.equal(fp, again)


def test_id_hash_lanes_match_reference():
    """The port's int64 lanes hold the reference's uint32 lanes exactly, up
    to the hd1080 scene's 2**19 Gaussians, and are cached per device."""
    for n in (1, 3, 1000, 1 << 19):
        want = np.asarray(jcoh._id_hash_lanes(n)).astype(np.int64)
        got = coh._id_hash_lanes(n)
        assert got.dtype == torch.int64 and got.shape == (n, 2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF
    assert coh._id_hash_lanes(1000) is coh._id_hash_lanes(1000, "cpu")


# ---------------------------------------------------------------------------
# the headline contract
# ---------------------------------------------------------------------------

def test_incremental_bit_matches_full_along_trajectory():
    """8 frames of smooth orbit + one jump-cut, under {CLAMP, SPILL} x
    {fused False, True}: every incremental frame is bit-identical to a
    cold-cache (full recompaction) render, and the smooth segment really
    reuses tiles (the parity is not vacuous)."""
    _, scene = ref_scene(0)
    cams = trajectory_cameras(8, width=RES, height=RES, step=STEP,
                              jump_frames=(5,))
    for policy in ("clamp", "spill"):
        for fused in (False, True):
            plan = make_plan(policy, fused)
            tiles = plan.grid.make().num_tiles
            cache, reused_total = None, 0
            for cam in cams:
                out_i, c_i, cache = render_incremental(plan, scene, cam,
                                                       cache)
                out_f, c_f, _ = render_incremental(plan, scene, cam, None)
                assert_frames_equal(out_i, c_i, out_f, c_f)
                want, wc = plan.render_with_stats(scene, cam)
                assert_frames_equal(out_f, c_f, want, dict(
                    wc, **{k: c_f[k] for k in COHERENCE_KEYS}))
                reused = int(c_i["tiles_reused"])
                assert reused + int(c_i["tiles_recompacted"]) == tiles
                reused_total += reused
            assert reused_total > 0, (policy, fused)
            assert cache.frames == len(cams)
            assert cache.tiles_reused == reused_total


def test_lists_and_counters_match_reference():
    """The port's `render_incremental` against the reference's along the
    same trajectory, CLAMP and SPILL: cached lists and valid bits and the
    three coherence counters exactly, images within 2e-4 (the reference's
    programs are jitted, F4), the same counter keys."""
    jscene, scene = ref_scene(0)
    jcams = jtrajectory(8, width=RES, height=RES, step=STEP,
                        jump_frames=(5,))
    cams = [convert.camera_from_numpy(fields(c)) for c in jcams]
    for policy in ("clamp", "spill"):
        plan, jplan = make_plan(policy), make_ref_plan(policy)
        cache = jcache = None
        for cam, jcam in zip(cams, jcams):
            out, c, cache = render_incremental(plan, scene, cam, cache)
            jout, jc, jcache = jcoh.render_incremental(jplan, jscene, jcam,
                                                       jcache)
            np.testing.assert_array_equal(cache.rows.numpy(),
                                          np.asarray(jcache.rows))
            np.testing.assert_array_equal(cache.valid.numpy(),
                                          np.asarray(jcache.valid))
            np.testing.assert_array_equal(cache.fp,
                                          np.asarray(jcache.fp, np.int64))
            for k in COHERENCE_KEYS:
                assert float(c[k]) == float(jc[k]), k
            assert set(c) == set(jc)
            np.testing.assert_allclose(out.image.numpy(),
                                       np.asarray(jout.image), rtol=0,
                                       atol=2e-4)
        assert (cache.tiles_reused, cache.tiles_recompacted,
                cache.full_recompactions) == (
            jcache.tiles_reused, jcache.tiles_recompacted,
            jcache.full_recompactions)
        assert cache.tiles_reused > 0


# ---------------------------------------------------------------------------
# fallback policy
# ---------------------------------------------------------------------------

def test_jump_cut_forces_full_recompaction():
    """Smooth frames reuse; the jump-cut frame (camera_delta past the
    threshold) recompacts everything and is charged as a full
    recompaction; camera_delta equals the reference's."""
    _, scene = ref_scene(1)
    plan = make_plan("clamp")
    cfg = CoherenceConfig()
    assert (cfg.max_changed_frac, cfg.max_camera_jump,
            cfg.min_changed_bucket) == (0.5, 3.0, 8)
    jump = 4
    jcams = jtrajectory(7, width=RES, height=RES, step=STEP,
                        jump_frames=(jump,))
    cams = [convert.camera_from_numpy(fields(c)) for c in jcams]
    assert camera_delta(cams[jump - 1], cams[jump]) > cfg.max_camera_jump
    assert camera_delta(cams[1], cams[2]) < cfg.max_camera_jump
    for i in (1, jump):
        assert camera_delta(cams[i - 1], cams[i]) == pytest.approx(
            jcoh.camera_delta(jcams[i - 1], jcams[i]), rel=1e-12)
    tiles = plan.grid.make().num_tiles
    cache = None
    for i, cam in enumerate(cams):
        _, c, cache = render_incremental(plan, scene, cam, cache, cfg)
        if i in (0, jump):                  # cold cache / jump-cut
            assert float(c["full_recompactions"]) == 1.0
            assert int(c["tiles_reused"]) == 0
            assert int(c["tiles_recompacted"]) == tiles
        else:
            assert float(c["full_recompactions"]) == 0.0
            assert int(c["tiles_reused"]) > 0
        assert all(c[k].dtype == torch.float32 and c[k].dim() == 0
                   for k in COHERENCE_KEYS)
    assert cache.full_recompactions == 2


def test_changed_frac_threshold_falls_back():
    """max_changed_frac=0.0 makes any candidate-set change a full
    recompaction; the fallback path keeps parity."""
    _, scene = ref_scene(2)
    plan = make_plan("clamp")
    strict = CoherenceConfig(max_changed_frac=0.0)
    cams = trajectory_cameras(3, width=RES, height=RES, step=STEP)
    cache = None
    for cam in cams:
        out_i, c_i, cache = render_incremental(plan, scene, cam, cache,
                                               strict)
        out_f, c_f, _ = render_incremental(plan, scene, cam, None)
        assert_frames_equal(out_i, c_i, out_f, c_f)
    assert cache.full_recompactions == 3
    assert cache.tiles_reused == 0


def test_scene_and_plan_swap_invalidate_cache():
    """A different scene or a value-unequal plan with a warm cache reuses
    nothing from it: the frame is a full recompaction into a fresh cache.
    The Renderer facade serves the same frames."""
    _, a = ref_scene(3)
    _, b = ref_scene(4)
    plan = make_plan("clamp")
    cam = orbit_camera(0.0, RES, RES)
    _, _, cache_a = render_incremental(plan, a, cam, None)
    _, _, cache_a = render_incremental(
        plan, a, orbit_camera(STEP, RES, RES), cache_a)

    out_b, c_b, cache_b = render_incremental(plan, b, cam, cache_a)
    assert cache_b is not cache_a
    assert cache_b.scene is b
    assert float(c_b["full_recompactions"]) == 1.0
    out_ref, c_ref, _ = render_incremental(plan, b, cam, None)
    assert_frames_equal(out_b, c_b, out_ref, c_ref)

    wider = dataclasses.replace(plan, stream=StreamConfig(k_max=512))
    _, c_w, cache_w = render_incremental(wider, a, cam, cache_a)
    assert cache_w is not cache_a
    assert cache_w.plan == wider
    assert float(c_w["full_recompactions"]) == 1.0

    r = Renderer.from_plan(plan)
    out_r, c_r, cache_r = r.render_incremental(b, cam)
    assert_frames_equal(out_r, c_r, out_ref, c_ref)
    out_r2, c_r2, _ = r.render_incremental(
        b, orbit_camera(STEP, RES, RES), cache_r)
    assert float(c_r2["full_recompactions"]) == 0.0
    out_p2, c_p2, _ = plan.render_incremental(
        b, orbit_camera(STEP, RES, RES), None)
    assert_frames_equal(out_r2, c_r2, out_p2, c_p2)


def test_spill_pass_usage_change_keeps_parity():
    """A jump-cut lands the camera where per-tile survivor lists are longer
    or shorter, so spill_passes moves mid-trajectory; parity holds on every
    frame either side of the change."""
    _, scene = ref_scene(8, 300, scale_range=(-2.9, -2.4), stretch=4.0,
                         opacity_range=(-1.0, 3.0))
    plan = RenderPlan(grid=GridConfig(height=RES, width=RES),
                      test=TestConfig(method="cat", precision=MIXED),
                      stream=StreamConfig(k_max=8,
                                          overflow=OverflowPolicy.SPILL,
                                          max_spill_passes=64))
    cams = trajectory_cameras(6, width=RES, height=RES, step=STEP,
                              jump_frames=(3,), jump_offset=1.0)
    cache, passes_seen = None, set()
    for cam in cams:
        out_i, c_i, cache = render_incremental(plan, scene, cam, cache)
        out_f, c_f, _ = render_incremental(plan, scene, cam, None)
        assert_frames_equal(out_i, c_i, out_f, c_f)
        assert not bool(out_i.overflow)
        passes_seen.add(float(c_i["spill_passes"]))
    assert len(passes_seen) >= 2, \
        "trajectory must actually change the spill pass usage"


# ---------------------------------------------------------------------------
# F2: the re-sort keeps the order of ties
# ---------------------------------------------------------------------------

def test_resort_rows_keeps_tie_order():
    """Depths drawn from three values (many ties) and rows holding shuffled
    members with invalid slots interleaved (holding stale ids): the port's
    re-sort equals the reference's exactly, rows and valid bits, so tied
    depths rank by index and equal keys keep their slot order."""
    rng = np.random.default_rng(0)
    n, t, k = 200, 6, 48
    jscene, _ = ref_scene(5, n)
    d = fields(jproject(jscene, jorbit(0.3, RES, RES)))
    d["depth"] = rng.choice(np.float32([2.0, 3.0, 4.5]), size=n)
    d["in_frustum"] = rng.random(n) < 0.9
    jp = jgaussians.Projected(**{f: jax.numpy.asarray(v)
                                 for f, v in d.items()})
    proj = convert.projected_from_numpy(d)
    rows = np.stack([rng.permutation(n)[:k] for _ in range(t)])
    valid = rng.random((t, k)) < 0.7
    rows = rows.astype(np.int32)
    jrows, jvalid = jcoh._resort_rows(jp, jax.numpy.asarray(rows),
                                      jax.numpy.asarray(valid))
    got_rows, got_valid = coh._resort_rows(proj, torch.from_numpy(rows),
                                           torch.from_numpy(valid),
                                           depth_order(proj))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(jvalid))
    # valid members come first, ordered by (depth, index) among the
    # in-frustum ones; invalid slots keep their slot order at the end.
    order = np.lexsort((np.arange(n), np.where(d["in_frustum"], d["depth"],
                                               np.inf)))
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    for r in range(t):
        m = int(valid[r].sum())
        assert got_valid[r, :m].all() and not got_valid[r, m:].any()
        np.testing.assert_array_equal(
            got_rows[r, :m].numpy(), rows[r][valid[r]][np.argsort(
                rank[rows[r][valid[r]]], kind="stable")])
        np.testing.assert_array_equal(got_rows[r, m:].numpy(),
                                      rows[r][~valid[r]])


def test_span_tree():
    """Under an enabled tracer a cold frame nests the full render's stage
    tree (render > preprocess, stage1_compact, ctu, blend, finalize) and a
    warm one the incremental render's (stage1_incremental in place of
    stage1_compact), each under render_incremental > stage1_incremental,
    whose attributes carry the decision."""
    _, scene = ref_scene(0)
    plan = make_plan("spill")
    cams = trajectory_cameras(2, width=RES, height=RES, step=STEP)
    tracer = obs_trace.Tracer()
    cache = None
    with obs_trace.use_tracer(tracer):
        for cam in cams:
            _, _, cache = render_incremental(plan, scene, cam, cache)
    assert [r.name for r in tracer.roots] == ["render_incremental"] * 2
    n = plan.n_passes
    for root, first in zip(tracer.roots, ("stage1_compact",
                                          "stage1_incremental")):
        decision, = root.children
        assert decision.name == "stage1_incremental"
        frame, = decision.children
        assert frame.name == "render"
        assert frame.attrs["incremental"] == (first == "stage1_incremental")
        assert [c.name for c in frame.children] == (
            ["preprocess", first] + ["ctu"] * n + ["blend"] * n
            + ["finalize"])
        assert decision.attrs["tiles_reused"] + \
            decision.attrs["tiles_recompacted"] == decision.attrs["tiles"]
        assert root.attrs["tiles_reused"] == decision.attrs["tiles_reused"]
    assert tracer.roots[0].attrs["full_recompaction"] is True
    assert tracer.roots[1].attrs["full_recompaction"] is False
