"""The port's tile-sharded rendering (`RenderPlan.shard`,
`repro_torch.distributed`) on the CPU, against its own single-device path
and against the JAX reference.

Sharding changes the schedule, never the numbers: over meshes of repeated
CPU devices (`[torch.device("cpu")] * S`, the counterpart of the
reference's forced host devices) the sharded frame equals the port's
single-device frame bit for bit (image, alpha, entry_alive, work maps and
every shared counter) under {CLAMP, SPILL} x {unfused, fused} at S in
{2, 4} on `small_scene` at 64². Against the reference: from the
reference's own Projected, the sharded frame is held to the reference's
eager single-device render (image and alpha atol 2e-4, the
`docs/kernels.md` contract; integer counters, entry_alive and the work
maps exact, means at rtol 1e-6: eager MIXED CAT is exact, fault F4 only
bites jitted references), and `tile_shards`, `shard_entries_max` and
`shard_entries_min` equal the reference's expressions evaluated on the
reference's own single-device streams. The reference's sharded render is
not used. `render_tile_subset` rows equal the full frame's rows and the
reference's rows; shard-drop recovery restores the healthy frame under
its parity gate; `render_incremental` and `render_lod_with_stats` under a
sharded plan equal their unsharded counterparts. The reference's "must run
under jax.jit" error has no counterpart: the port is eager, so a sharded
render runs wherever a mesh is active. `StragglerMonitor` is held to the
reference's on one sequence of step times fed through a patched
`time.perf_counter` (the reference's own test sleeps, and is flaky).

At most eleven tests, so that this file sorts after
`test_stream_properties.py` in the tier-1 xdist queue.
"""
import dataclasses
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        RasterConfig as JRaster, RenderPlan as JPlan,
                        ShardConfig as JShard, StreamConfig as JStream,
                        TestConfig as JTest)
from repro.core import raster as jraster
from repro.core.culling import TileGrid as JTileGrid
from repro.core.precision import MIXED as J_MIXED
from repro.distributed.fault import StragglerMonitor as JStragglerMonitor
from repro.obs.trace import NoopTracer as JNoopTracer

from repro_torch import convert
from repro_torch import ShardConfig as TopShardConfig
from repro_torch.core import (MIXED, GridConfig, ProjectedScene,
                              RasterConfig, Renderer, RenderPlan,
                              ShardConfig, StreamConfig, TestConfig,
                              as_plan, orbit_camera, raster, stack_cameras)
from repro_torch.core.coherence import render_incremental
from repro_torch.distributed import (ShardDropInjector, StragglerMonitor,
                                     render_with_shard_recovery)
from repro_torch.distributed import sharding as dshard
from repro_torch.lod import LODConfig, build_lod
from repro_torch.serving import sharding as shd

SIZE = 64
SHARD_KEYS = ("tile_shards", "shard_entries_max", "shard_entries_min")
MEAN_COUNTERS = {"leader_tests_per_pair", "processed_per_pixel",
                 "blended_per_pixel"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    names = ([f.name for f in dataclasses.fields(obj)]
             if dataclasses.is_dataclass(obj) else obj._fields)
    return {n: np.asarray(getattr(obj, n)) for n in names}


@pytest.fixture(scope="module")
def port_inputs(small_scene, cam64):
    return (convert.scene_from_numpy(fields(small_scene)),
            convert.camera_from_numpy(fields(cam64)))


def cpu_mesh(s: int, frames: int = 1):
    return shd.tile_mesh(s, frame_shards=frames,
                         devices=[torch.device("cpu")] * (s * frames))


def make_plan(policy="clamp", fused=False, shards=1, precision=MIXED):
    return RenderPlan(
        grid=GridConfig(SIZE, SIZE),
        test=TestConfig(backend="cuda" if fused else "torch",
                        precision=precision),
        stream=StreamConfig(k_max=64, overflow=policy, max_spill_passes=3),
        raster=RasterConfig(fused=fused),
        shard=ShardConfig(tile_shards=shards))


def quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def sharded(plan, s, fn, *args, **kw):
    """fn of a copy of `plan` with s tile shards, under a [cpu]*s mesh."""
    with dshard.use_mesh(cpu_mesh(s)):
        return quiet(getattr(dataclasses.replace(
            plan, shard=ShardConfig(tile_shards=s)), fn), *args, **kw)


def assert_same_frame(a, ac, b, bc):
    """Every RenderOut field and every counter of (a, ac) in (b, bc)."""
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    bad = [k for k in ac if not torch.equal(ac[k], bc[k])]
    assert not bad, f"counter mismatch: {bad}"


# ---------------------------------------------------------------------------
# retile, stages, configs
# ---------------------------------------------------------------------------

def test_retile_and_stages_match_reference():
    """`raster.retile` equals the reference's and inverts `untile`;
    `RenderPlan.stages()` equals the reference's stage for stage, its
    backend names read in the port's ("jnp" -> "torch", "pallas" ->
    "cuda")."""
    rng = np.random.default_rng(0)
    for h, w, c in ((64, 64, (3,)), (32, 96, ()), (48, 16, (2,))):
        x = rng.standard_normal((h, w) + c).astype(np.float32)
        got = raster.retile(GridConfig(h, w).make(), torch.from_numpy(x))
        want = jraster.retile(JTileGrid(h, w), jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(raster.untile(GridConfig(h, w).make(), got),
                           torch.from_numpy(x))

    names = {"jnp": "torch", "pallas": "cuda"}
    for method in ("cat", "obb", "aabb"):
        for fused in (False, True):
            for policy in ("clamp", "spill"):
                for dataflow in (("stream", "dense") if method == "cat"
                                 else ("stream",)):
                    stream = dict(k_max=128, overflow=policy,
                                  max_spill_passes=4)
                    jplan = JPlan(
                        test=JTest(method=method,
                                   backend="pallas" if fused else "jnp"),
                        stream=JStream(**dict(
                            stream, overflow=JPolicy(policy))),
                        raster=JRaster(fused=fused), dataflow=dataflow)
                    plan = RenderPlan(
                        test=TestConfig(method=method,
                                        backend="cuda" if fused else "torch"),
                        stream=StreamConfig(**stream),
                        raster=RasterConfig(fused=fused), dataflow=dataflow)
                    want = [(s.name, names[s.backend],
                             s.description.replace("jnp", "torch"))
                            for s in jplan.stages()]
                    got = [(s.name, s.backend, s.description)
                           for s in plan.stages()]
                    assert got == want, (method, fused, policy, dataflow)


def test_shard_config_and_plan_validation():
    """ShardConfig and the plan's sharding check raise the reference's
    messages; the shard joins the plan's value (hash, equality), the
    facade, `replace`, `as_plan` and both packages' exports."""
    with pytest.raises(ValueError) as want:
        JShard(tile_shards=0)
    with pytest.raises(ValueError) as got:
        ShardConfig(tile_shards=0)
    assert str(got.value) == str(want.value)
    for kw, jkw in ((dict(dataflow="dense"), dict(dataflow="dense")),
                    (dict(test=TestConfig(method="obb")),
                     dict(test=JTest(method="obb")))):
        with pytest.raises(ValueError) as want:
            JPlan(shard=JShard(tile_shards=2), **jkw)
        with pytest.raises(ValueError) as got:
            RenderPlan(shard=ShardConfig(tile_shards=2), **kw)
        assert str(got.value) == str(want.value)
        assert "stream dataflow" in str(got.value)
    assert [f.name for f in dataclasses.fields(ShardConfig)] == \
        [f.name for f in dataclasses.fields(JShard)]
    assert ShardConfig() == ShardConfig(1, "tile")
    assert [f.name for f in dataclasses.fields(RenderPlan)] == \
        [f.name for f in dataclasses.fields(JPlan)]
    p2 = RenderPlan(shard=ShardConfig(2))
    assert p2 != RenderPlan() and hash(p2) == hash(RenderPlan(
        shard=ShardConfig(2)))
    r = Renderer(shard=ShardConfig(4))
    assert r.plan.shard.tile_shards == 4
    assert r.replace(shard=ShardConfig()).plan == RenderPlan()
    assert as_plan(r) is r.plan and as_plan(p2) is p2
    with pytest.raises(TypeError, match="cannot build a RenderPlan"):
        as_plan(3)
    assert TopShardConfig is ShardConfig


# ---------------------------------------------------------------------------
# sharded == single, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("policy", ["clamp", "spill"])
def test_sharded_equals_single(port_inputs, policy, fused):
    """S in {2, 4} shards over [cpu]*S: image, alpha, entry_alive, work
    maps and every counter of the single-device frame, plus the occupancy
    counters; the span tree keeps the single-device shape, its ctu and
    blend spans marked sharded."""
    from repro_torch.obs import Tracer, use_tracer
    scene, cam = port_inputs
    plan = make_plan(policy, fused)
    ref, rc = quiet(plan.render_with_stats, scene, cam)
    if policy == "spill":
        assert float(rc["spill_passes"]) > 1
    for s in (2, 4):
        with use_tracer(Tracer()) as tracer:
            out, c = sharded(plan, s, "render_with_stats", scene, cam)
        assert_same_frame(ref, rc, out, c)
        assert set(c) == set(rc) | set(SHARD_KEYS)
        assert float(c["tile_shards"]) == s
        assert c["shard_entries_max"] >= c["shard_entries_min"] > 0
        root, = tracer.roots
        assert root.attrs["tile_shards"] == s
        kids = [k.name for k in root.children]
        assert kids == (["preprocess", "stage1_compact"]
                        + ["ctu"] * plan.n_passes + ["blend"] * plan.n_passes
                        + ["finalize"])
        for sp in root.children[2:-1]:
            assert sp.attrs["sharded"] and sp.attrs["tile_shards"] == s
        # The blend deltas sum to the frame's work, as unsharded.
        total = sum(sp.attrs["processed_delta"] for sp in root.find("blend"))
        assert total == float(out.processed_per_pixel.sum(
            dtype=torch.float64))


def test_sharded_frame_matches_reference(small_scene, cam64):
    """From the reference's own Projected (SPILL, MIXED, 3 passes of 64):
    the port's 4-shard frame against the reference's eager single-device
    tail, and the occupancy counters against the reference's expressions
    (renderer.py's shard accounting) on the reference's own streams."""
    jplan = JPlan(grid=JGrid(SIZE, SIZE), test=JTest(precision=J_MIXED),
                  stream=JStream(k_max=64, overflow=JPolicy.SPILL,
                                 max_spill_passes=3))
    jps = jplan.preprocess(small_scene, cam64)
    jstreams = jplan.stage1_compact(jps)
    want, wc = quiet(jplan._render_streams, jps, jstreams, JNoopTracer())
    plan = make_plan("spill", fused=False)
    ps = ProjectedScene(convert.projected_from_numpy(fields(jps.proj)),
                        plan.grid.make())
    streams = plan.stage1_compact(ps)
    got, gc = sharded(plan, 4, "_render_streams", ps, streams)
    for name in ("image", "alpha"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-4, err_msg=name)
    for name in ("processed_per_pixel", "blended_per_pixel", "entry_alive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert set(gc) == set(wc) | set(SHARD_KEYS)
    for key, w in wc.items():
        if key in MEAN_COUNTERS:
            np.testing.assert_allclose(float(gc[key]), float(w), rtol=1e-6,
                                       err_msg=key)
        else:
            assert float(gc[key]) == float(w), key
    for s, (g, gcs) in ((4, (got, gc)),
                        (2, sharded(plan, 2, "_render_streams", ps,
                                    streams))):
        valid_all = jnp.stack([ts.valid for ts in jstreams])
        t = jps.grid.num_tiles
        per_shard = jnp.sum(valid_all.reshape(len(jstreams), s, t // s, -1),
                            axis=(0, 2, 3))
        assert float(gcs["tile_shards"]) == float(s)
        assert float(gcs["shard_entries_max"]) == float(jnp.max(per_shard))
        assert float(gcs["shard_entries_min"]) == float(jnp.min(per_shard))


def test_render_tile_subset_rows(small_scene, cam64, port_inputs):
    """Arbitrary row subsets re-render equal to the full frame's rows
    (fused and unfused, SPILL) and to the reference's
    `render_tile_subset` rows (image atol 2e-4, entry_alive exact); the
    row path refuses the dense oracle with the reference's message."""
    scene, cam = port_inputs
    grid = GridConfig(SIZE, SIZE).make()
    ids = [0, 5, 7, 15]
    for fused in (False, True):
        plan = make_plan("spill", fused)
        full, _ = quiet(plan.render_with_stats, scene, cam)
        rows = quiet(plan.render_tile_subset, scene, cam, torch.tensor(ids))
        for key, field in (("image", "image"), ("alpha", "alpha"),
                           ("processed", "processed_per_pixel"),
                           ("blended", "blended_per_pixel")):
            assert torch.equal(rows[key], raster.retile(
                grid, getattr(full, field))[ids]), (fused, key)
        assert torch.equal(rows["entry_alive"], full.entry_alive[ids])
    jplan = JPlan(grid=JGrid(SIZE, SIZE), test=JTest(precision=J_MIXED),
                  stream=JStream(k_max=64, overflow=JPolicy.SPILL,
                                 max_spill_passes=3))
    jrows = quiet(jplan.render_tile_subset, small_scene, cam64,
                  jnp.asarray(ids))
    rows = quiet(make_plan("spill").render_tile_subset, scene, cam, ids)
    for key in ("image", "alpha"):
        np.testing.assert_allclose(rows[key].numpy(), np.asarray(jrows[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    np.testing.assert_array_equal(rows["entry_alive"].numpy(),
                                  np.asarray(jrows["entry_alive"]))
    with pytest.raises(ValueError) as want:
        JPlan(dataflow="dense").render_tile_subset(None, None, None)
    with pytest.raises(ValueError) as got:
        RenderPlan(dataflow="dense").render_tile_subset(None, None, None)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# distributed.fault
# ---------------------------------------------------------------------------

def test_shard_drop_recovery_and_straggler_monitor(port_inputs,
                                                   monkeypatch):
    """Shards 1 and 3 of 4 dropped: half the tiles re-rendered, the frame
    equal to the healthy one (the gate raised otherwise), the counters;
    the next frame healthy. The injector's and the entry point's checks
    raise the reference's messages. StragglerMonitor flags the steps the
    reference's flags on one sequence of step times."""
    scene, cam = port_inputs
    plan = make_plan("spill", fused=True, shards=4)
    mesh = cpu_mesh(4)
    inj = ShardDropInjector(drop=(1, 3))
    out, counters, report = quiet(render_with_shard_recovery, plan, scene,
                                  cam, injector=inj, mesh=mesh)
    n_tiles = plan.grid.make().num_tiles
    assert report.dropped_shards == (1, 3)
    assert report.tiles_recovered == n_tiles // 2 and report.parity_ok
    assert float(counters["shard_drops"]) == 2.0
    assert float(counters["tiles_recovered"]) == n_tiles // 2
    with dshard.use_mesh(mesh):
        healthy, hc = quiet(plan.render_with_stats, scene, cam)
    assert_same_frame(healthy, hc, out, counters)
    out2, c2, report2 = quiet(render_with_shard_recovery, plan, scene, cam,
                              injector=inj, mesh=mesh)
    assert report2.dropped_shards == () and float(c2["shard_drops"]) == 0.0
    assert torch.equal(out.image, out2.image)

    from repro.distributed.fault import ShardDropInjector as JInjector
    from repro.distributed.fault import render_with_shard_recovery as jrwsr
    for make in (JInjector, ShardDropInjector):
        assert make().take(4) == ()
    with pytest.raises(ValueError) as want:
        JInjector(drop=(7,)).take(4)
    with pytest.raises(ValueError) as got:
        ShardDropInjector(drop=(7,)).take(4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jrwsr(JPlan(), None, None, injector=JInjector())
    with pytest.raises(ValueError) as got:
        render_with_shard_recovery(RenderPlan(), None, None,
                                   injector=ShardDropInjector())
    assert str(got.value) == str(want.value)

    steps = [0.003, 0.0031, 0.0029, 0.003, 0.0032, 0.003, 0.0028, 0.003,
             0.003, 0.0044, 0.05, 0.003, 0.0044, 0.2, 0.003]
    clock = None
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    flags = {}
    for name, make in (("port", StragglerMonitor),
                       ("ref", JStragglerMonitor)):
        clock = iter(np.cumsum([x for dt in steps for x in (1.0, dt)]))
        mon = make(window=16, threshold=1.5)
        got_flags = []
        for i in range(len(steps)):
            mon.step_start(i)
            got_flags.append(mon.step_end())
        flags[name] = (got_flags, [s for s, _ in mon.flagged], mon.median)
    assert flags["port"] == flags["ref"]
    assert flags["port"][1] == [10, 13]


# ---------------------------------------------------------------------------
# errors, meshes, shard_frames
# ---------------------------------------------------------------------------

def test_sharded_errors_mesh_and_shard_frames(port_inputs):
    """No active mesh, a mesh axis of the wrong size and tiles not
    divisible by the shards raise the reference's errors; `resolve`,
    `dp_axes`, `use_mesh` nesting; `tile_mesh` with too few devices names
    devices=; `shard_frames` pads an odd batch by repeating the last frame
    and leaves an exact multiple alone; `replicate` copies once per
    distinct device."""
    scene, cam = port_inputs
    plan = make_plan(shards=4)
    with pytest.raises(RuntimeError, match="no active mesh"):
        quiet(plan.render_with_stats, scene, cam)
    with dshard.use_mesh(cpu_mesh(2)):
        with pytest.raises(ValueError, match="has size 2"):
            quiet(plan.render_with_stats, scene, cam)
    with dshard.use_mesh(cpu_mesh(3)):
        with pytest.raises(ValueError, match="not divisible"):
            quiet(make_plan(shards=3).render_with_stats, scene, cam)
    assert dshard.active_mesh() is None

    mesh = cpu_mesh(2, frames=3)
    assert mesh.shape == {"data": 3, "model": 2}
    assert mesh.row(2).devices == (mesh.devices[2],)
    assert dshard.dp_axes(mesh) == ("data",)
    assert dshard.resolve(("tile", "dp", None), mesh) == \
        ("model", ("data",), None)
    with pytest.raises(ValueError, match="unknown logical axis"):
        dshard.resolve(("expert",), mesh)
    with dshard.use_mesh(mesh):
        with dshard.use_mesh(None):
            assert dshard.active_mesh() is mesh
        inner = cpu_mesh(1)
        with dshard.use_mesh(inner):
            assert dshard.active_mesh() is inner
        assert dshard.active_mesh() is mesh
    assert dshard.active_mesh() is None
    assert (shd.data_parallel_size(mesh), shd.tile_parallel_size(mesh)) \
        == (3, 2)
    with pytest.raises(ValueError, match=r"devices=\[") as err:
        shd.tile_mesh(3, devices=[torch.device("cpu")] * 2)
    assert "needs 3 devices" in str(err.value)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="devices="):
            shd.tile_mesh(2)

    cams = stack_cameras([orbit_camera(2 * np.pi * i / 8, 32, 32)
                          for i in range(3)])
    groups = shd.shard_frames(cams, cpu_mesh(1, frames=2))
    assert [g.frames for g in groups] == [2, 2]
    for f in ("R_wc", "t_wc", "fx", "fy", "cx", "cy"):
        placed = torch.cat([getattr(g, f) for g in groups])
        assert torch.equal(placed[:3], getattr(cams, f))
        assert torch.equal(placed[3], getattr(cams, f)[2])
    cams4 = stack_cameras([orbit_camera(0.1 * i, 32, 32) for i in range(4)])
    assert [g.frames for g in shd.shard_frames(cams4, cpu_mesh(
        1, frames=2))] == [2, 2]
    reps = shd.replicate(scene, cpu_mesh(4))
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")].means is scene.means


# ---------------------------------------------------------------------------
# sharded coherence and LOD
# ---------------------------------------------------------------------------

def test_incremental_and_lod_sharded(port_inputs):
    """`render_incremental` over two poses (cold, then a reuse frame) and
    `render_lod_with_stats` under a 4-shard plan equal their unsharded
    counterparts bit for bit, the occupancy counters aside."""
    scene, cam = port_inputs
    plan = make_plan("spill", fused=True)
    cam2 = dataclasses.replace(cam, t_wc=cam.t_wc + torch.tensor(
        [1e-4, 0.0, 0.0]))
    cache = scache = None
    for c in (cam, cam2):
        out, cc, cache = quiet(render_incremental, plan, scene, c, cache)
        sout, sc, scache = sharded(plan, 4, "render_incremental", scene, c,
                                   scache)
        assert_same_frame(out, cc, sout, sc)
        assert set(sc) == set(cc) | set(SHARD_KEYS)
    assert float(cc["tiles_reused"]) > 0

    cfg = LODConfig(num_clusters=16, probe_k_max=128, probe_passes=2,
                    min_bucket=64)
    lod = quiet(build_lod, scene, [cam, cam2], cfg, grid=plan.grid,
                init=(None, torch.arange(16) * (scene.n // 16)))
    lplan = dataclasses.replace(plan, lod=cfg)
    out, lc = quiet(lplan.render_lod_with_stats, lod, cam)
    sout, slc = sharded(lplan, 4, "render_lod_with_stats", lod, cam)
    assert_same_frame(out, lc, sout, slc)
    assert float(slc["tile_shards"]) == 4.0
    assert 0 < float(lc["lod_selection_ratio"]) <= 1.0
