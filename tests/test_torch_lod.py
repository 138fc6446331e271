"""The port's camera-dependent LOD stage (`repro_torch.lod`, with
`core/clustering.py` and `core/pruning.py` under it) against the JAX
reference, at 32 px on scenes of at most 900 Gaussians drawn by the
reference's `random_scene` and converted.

k-means takes the reference's own fit and center indices (drawn from the
same key with `jax.random.split`/`choice`; the port draws from a
`torch.Generator` and does not reproduce jax streams): assignments and
counts equal the reference's exactly, centers and radii within 1e-6
relative. The build's layout (member_cluster, counts, starts, the
reordered padded scene) is exact; contribution scores and cluster masses
are float scatter-adds and are held within rtol 1e-5. Selection, member
masks, gather and `measure_lod_k_max` run on the reference's own
`LODScene` (converted), so a last-bit change of mass can never move a
cluster across `mass_floor * total`, and are exact.

`render_lod_with_stats`: with the footprint and mass tests off, the LOD
frame equals the port's plain render bit for bit under {CLAMP, SPILL} x
{unfused, fused} on every tile; with real selection it is within 2e-4 of
the reference's eager LOD render (fault F4: no jitted reference), with
equal `lod_*` counters, at least 30 dB against the full frame, and the
reference's `stage0_lod` span. The reference's refusal of an unpinned
selection bucket under jit/vmap has no counterpart: every render of the
port is eager, so the selected count is known on the host.

The engine's LOD path on the CPU: counters, gauges, plan-cache reuse, a
plain scene beside it, `plan_for(lod_bucket=)`, the registration errors,
and each frame against the reference engine's (jitted: 2e-4).
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        RenderPlan as JPlan,
                        StreamConfig as JStream, TestConfig as JTest)
from repro.core import orbit_camera as jorbit, psnr as jpsnr
from repro.core import random_scene as jrandom_scene, ssim as jssim
from repro.core import clustering as jclustering
from repro.core.camera import default_camera as jdefault_camera
from repro.core.culling import TileGrid as JTileGrid
from repro.core.gaussians import project as jproject
from repro.core.precision import MIXED as J_MIXED
from repro.core.pruning import contribution_scores as jscores
from repro.core.pruning import prune as jprune
from repro import lod as jlod
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer, use_tracer as juse_tracer
from repro.serving import RenderEngine as JEngine
from repro.serving import RenderRequest as JRequest, Telemetry as JTelemetry

from repro_torch import convert
from repro_torch.core import (MIXED, GridConfig, OverflowPolicy,
                              RasterConfig, Renderer, RenderPlan,
                              StreamConfig, TestConfig, psnr, ssim)
from repro_torch.core import clustering
from repro_torch.core.gaussians import ALPHA_MIN
from repro_torch.core.pruning import contribution_scores, prune
from repro_torch.core.renderer import measure_k_max
from repro_torch.core.culling import TileGrid
from repro_torch.lod import (LODConfig, build_lod, gather_subscene,
                             measure_lod_k_max, member_mask,
                             select_clusters, selected_members,
                             selection_bucket_for)
from repro_torch.obs import MetricsRegistry, Tracer, use_tracer
from repro_torch.serving import RenderEngine, RenderRequest, Telemetry

RES = 32
GRID, JGRID = GridConfig(height=RES, width=RES), JGrid(height=RES, width=RES)
CFG_KW = dict(num_clusters=24, probe_k_max=128, probe_passes=2,
              min_bucket=64)
# Stage attributes the port adds to the reference's.
PORT_ONLY_ATTRS = {"frames"}
LOD_KEYS = ("lod_clusters_total", "lod_clusters_selected",
            "lod_gaussians_selected", "lod_selection_ratio", "lod_bucket")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    names = ([f.name for f in dataclasses.fields(obj)]
             if dataclasses.is_dataclass(obj) else obj._fields)
    return {n: np.asarray(getattr(obj, n)) for n in names}


@functools.lru_cache(maxsize=None)
def ref_scene(n=900, seed=7, extent=8.0):
    """The reference's wide LOD test scene (a real fraction of it lies
    outside a narrow camera), and its conversion."""
    scene = jrandom_scene(jax.random.PRNGKey(seed), n, extent=extent,
                          scale_range=(-2.9, -2.2), stretch=3.0,
                          opacity_range=(-1.0, 3.0))
    return scene, convert.scene_from_numpy(fields(scene))


def cam_pair(theta=None, fov=30.0, res=RES):
    """(reference camera, port camera): the narrow default camera, or an
    orbit pose at `theta`."""
    jcam = (jdefault_camera(res, res, fov_deg=fov) if theta is None else
            jorbit(theta, res, res, fov_deg=fov))
    return jcam, convert.camera_from_numpy(fields(jcam))


def ref_init(n, c, key=None):
    """The reference k-means' (fit_idx or None, center_idx) for `key`
    (PRNGKey(0) when None), as the port's `init`."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_init, k_fit = jax.random.split(key)
    fit_idx, m = None, n
    if n > jclustering.FIT_SAMPLE:
        fit_idx = torch.from_numpy(np.array(jax.random.choice(
            k_fit, n, (jclustering.FIT_SAMPLE,), replace=False)))
        m = jclustering.FIT_SAMPLE
    return fit_idx, torch.from_numpy(np.array(
        jax.random.choice(k_init, m, (c,), replace=False)))


def lod_from_ref(jl):
    d = fields(jl)
    d["scene"] = fields(jl.scene)
    return convert.lod_scene_from_numpy(d)


@pytest.fixture(scope="module")
def built():
    """The reference's build (two probes, 24 clusters) and the port's build
    from the reference's k-means indices, on the same scene."""
    jscene, scene = ref_scene()
    probes = [cam_pair(), cam_pair(0.4)]
    jcfg, cfg = jlod.LODConfig(**CFG_KW), LODConfig(**CFG_KW)
    jl = jlod.build_lod(jscene, [p[0] for p in probes], jcfg, grid=JGRID)
    tl = build_lod(scene, [p[1] for p in probes], cfg, grid=GRID,
                   init=ref_init(scene.n, cfg.num_clusters))
    return dict(jscene=jscene, scene=scene, probes=probes, jcfg=jcfg,
                cfg=cfg, jl=jl, tl=tl, ref_lod=lod_from_ref(jl))


def quiet(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args)


# ---------------------------------------------------------------------------
# config, clustering, cull, scores
# ---------------------------------------------------------------------------

def test_lod_config_and_selection_bucket():
    """Same fields, defaults, validation messages and plan hashing as the
    reference's LODConfig; selection_bucket_for equal over a grid."""
    assert ([(f.name, f.default) for f in dataclasses.fields(LODConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jlod.LODConfig)])
    for bad in (dict(num_clusters=0), dict(kmeans_iters=0),
                dict(probe_k_max=0), dict(probe_passes=0),
                dict(min_footprint_px=-1.0), dict(mass_floor=1.0),
                dict(mass_floor=-0.1), dict(min_bucket=300),
                dict(selection_bucket=100)):
        with pytest.raises(ValueError) as want:
            jlod.LODConfig(**bad)
        with pytest.raises(ValueError) as got:
            LODConfig(**bad)
        assert str(got.value) == str(want.value), bad
    assert RenderPlan(lod=LODConfig()) == RenderPlan(lod=LODConfig())
    assert hash(RenderPlan(lod=LODConfig())) == \
        hash(RenderPlan(lod=LODConfig()))
    assert RenderPlan() == RenderPlan(lod=None)
    assert hash(RenderPlan()) == hash(RenderPlan(lod=None))
    assert Renderer(lod=LODConfig()).plan.lod == LODConfig()
    for min_bucket in (1, 64, 256):
        for cap in (256, 4096):
            for count in (0, 1, 63, 64, 65, 700, 4096, 9000):
                assert selection_bucket_for(
                    count, LODConfig(min_bucket=min_bucket), cap) == \
                    jlod.selection_bucket_for(
                        count, jlod.LODConfig(min_bucket=min_bucket), cap)


def test_kmeans_matches_reference(monkeypatch):
    """With the reference's indices: assignments and counts exact, centers
    and radii within 1e-6 relative, on the full-fit path and (with
    FIT_SAMPLE lowered in both packages) the subsample path; the chunked
    assignment equals one block; deterministic under a generator."""
    jscene, scene = ref_scene(600)
    for c, fit_sample in ((16, None), (32, None), (48, None), (32, 256)):
        if fit_sample is not None:
            monkeypatch.setattr(jclustering, "FIT_SAMPLE", fit_sample)
            monkeypatch.setattr(clustering, "FIT_SAMPLE", fit_sample)
        want = jclustering.kmeans_clusters(jscene, c)
        got = clustering.kmeans_clusters(scene, c,
                                         init=ref_init(scene.n, c))
        np.testing.assert_array_equal(got.assign.numpy(),
                                      np.asarray(want.assign))
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
        np.testing.assert_allclose(got.centers.numpy(),
                                   np.asarray(want.centers), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(got.radii.numpy(), np.asarray(want.radii),
                                   rtol=1e-6, atol=0)
        monkeypatch.undo()
    cl = clustering.kmeans_clusters(scene, 32)
    assert torch.equal(clustering._assign_all(scene.means, cl.centers,
                                              block=64),
                       clustering._assign_block(scene.means, cl.centers))
    runs = [clustering.kmeans_clusters(
        scene, 32, generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for a, b in zip(cl, clustering.kmeans_clusters(scene, 32)):
        assert torch.equal(a, b)            # the default generator: seed 0
    assert int(cl.counts.sum()) == scene.n


def test_cluster_cull_and_traffic_match_reference():
    """cluster_frustum_cull equal to the reference's over seeds x fovs x
    poses on the reference's clustering, conservative against per-Gaussian
    frustum flags; memory_traffic_model equal."""
    for seed in (0, 3):
        jscene, scene = ref_scene(700, seed=seed)
        jcl = jclustering.kmeans_clusters(jscene, 48)
        cl = clustering.Clustering(*(torch.from_numpy(np.array(x))
                                     for x in jcl))
        for fov in (22.0, 45.0):
            for theta in (0.0, 2.0):
                jcam, cam = cam_pair(theta, fov)
                want = np.asarray(jclustering.cluster_frustum_cull(jcl, jcam))
                got = clustering.cluster_frustum_cull(cl, cam)
                np.testing.assert_array_equal(got.numpy(), want)
                in_frustum = np.asarray(jproject(jscene, jcam).in_frustum)
                assert np.all(want[np.asarray(jcl.assign)] | ~in_frustum)
                assert want.sum() < 48
                passing = torch.from_numpy(np.array(in_frustum))
                jt = jclustering.memory_traffic_model(
                    jcl, jax.numpy.asarray(want),
                    jax.numpy.asarray(in_frustum))
                t = clustering.memory_traffic_model(cl, got, passing)
                assert set(t) == set(jt)
                for k in jt:
                    assert float(t[k]) == float(jt[k]), k


def test_contribution_scores_and_prune_match_reference():
    """Scores within rtol 1e-5 of the reference's for one pass, two passes
    and an under-sized capacity (out-of-frustum Gaussians exactly 0); prune
    on the reference's scores keeps the reference's ids."""
    jscene, scene = ref_scene(400)
    jcam, cam = cam_pair()
    for k_max, passes in ((256, 1), (128, 2), (64, 1)):
        want = np.asarray(jscores(jscene, [jcam], JTileGrid(RES, RES),
                                  k_max=k_max, passes=passes))
        got = contribution_scores(scene, [cam], TileGrid(RES, RES),
                                  k_max=k_max, passes=passes).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
    out = ~np.asarray(jproject(jscene, jcam).in_frustum)
    assert np.all(got[out] == 0.0)
    for keep in (0.25, 0.6):
        jkept_scene, jkept = jprune(jscene, jax.numpy.asarray(want),
                                    keep_frac=keep)
        kept_scene, kept = prune(scene, torch.from_numpy(want),
                                 keep_frac=keep)
        np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
        for f, v in fields(jkept_scene).items():
            np.testing.assert_array_equal(getattr(kept_scene, f).numpy(), v)


# ---------------------------------------------------------------------------
# build, selection, gather
# ---------------------------------------------------------------------------

def test_build_lod_matches_reference(built):
    """From the reference's k-means indices: member_cluster, counts, starts
    and the reordered padded scene exact, centers/radii within 1e-6, mass
    within rtol 1e-5; padding inert; deterministic under a generator."""
    jl, tl = built["jl"], built["tl"]
    assert (tl.n_real, tl.n_padded, tl.n_clusters) == \
        (jl.n_real, jl.n_padded, jl.n_clusters) == (900, 1024, 24)
    for f in ("member_cluster", "counts", "starts"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                      np.asarray(getattr(jl, f)), err_msg=f)
    for f, v in fields(jl.scene).items():
        np.testing.assert_array_equal(getattr(tl.scene, f).numpy(), v,
                                      err_msg=f)
    np.testing.assert_allclose(tl.centers.numpy(), np.asarray(jl.centers),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.radii.numpy(), np.asarray(jl.radii),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.mass.numpy(), np.asarray(jl.mass),
                               rtol=1e-5, atol=0)
    assert float(tl.mass.sum()) > 0.0
    assert bool((tl.member_cluster[tl.n_real:] == -1).all())
    assert bool((torch.sigmoid(tl.scene.opacity_logits[tl.n_real:])
                 < ALPHA_MIN).all())
    scene, probes = built["scene"], [p[1] for p in built["probes"]]
    a, b = (build_lod(scene, probes, built["cfg"], grid=GRID,
                      generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for f in ("member_cluster", "centers", "radii", "counts", "starts",
              "mass"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.scene.means, b.scene.means)
    assert torch.equal(a.to("cpu").mass, a.mass)
    with pytest.raises(ValueError) as want:
        jlod.build_lod(built["jscene"], [], built["jcfg"], grid=JGRID)
    with pytest.raises(ValueError) as got:
        build_lod(scene, [], built["cfg"], grid=GRID)
    assert str(got.value) == str(want.value)


def test_selection_and_gather_match_reference(built):
    """On the reference's LODScene: select_clusters, member_mask,
    selected_members, the bucket, gather_subscene (also an under-sized
    bucket) and measure_lod_k_max equal the reference's exactly, over
    poses, fovs and the select-all configuration."""
    jl, lod = built["jl"], built["ref_lod"]
    off = dict(min_footprint_px=0.0, mass_floor=0.0)
    real_selection = 0
    for cfg_kw in (CFG_KW, dict(CFG_KW, **off), dict(CFG_KW, mass_floor=0.1)):
        jcfg, cfg = jlod.LODConfig(**cfg_kw), LODConfig(**cfg_kw)
        for theta, fov in ((None, 30.0), (0.4, 30.0), (2.0, 45.0)):
            jcam, cam = cam_pair(theta, fov)
            jsel = jlod.select_clusters(jl, jcam, jcfg)
            sel = select_clusters(lod, cam, cfg)
            np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
            np.testing.assert_array_equal(
                member_mask(lod, sel).numpy(),
                np.asarray(jlod.member_mask(jl, jsel)))
            n_sel = int(selected_members(lod, sel))
            assert n_sel == int(jlod.selected_members(jl, jsel))
            real_selection += 0 < n_sel < lod.n_real
            bucket = selection_bucket_for(n_sel, cfg, lod.n_padded)
            for b in (bucket, 64):
                jsub, jcount = jlod.gather_subscene(jl, jsel, b)
                sub, count = gather_subscene(lod, sel, b)
                assert int(count) == int(jcount) == n_sel
                for f, v in fields(jsub).items():
                    np.testing.assert_array_equal(getattr(sub, f).numpy(), v,
                                                  err_msg=f)
        cams = [cam_pair(), cam_pair(0.4)]
        for cap in (None, 64):
            assert measure_lod_k_max(lod, [c[1] for c in cams], cfg,
                                     grid=GRID, cap=cap) == \
                jlod.measure_lod_k_max(jl, [c[0] for c in cams], jcfg,
                                       grid=JGRID, cap=cap)
    assert real_selection >= 3
    sel = torch.ones(lod.n_clusters, dtype=torch.bool)
    for b in (0, 2 * lod.n_padded):
        with pytest.raises(ValueError) as want:
            jlod.gather_subscene(jl, jax.numpy.asarray(sel.numpy()), b)
        with pytest.raises(ValueError) as got:
            gather_subscene(lod, sel, b)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="probe camera"):
        measure_lod_k_max(lod, [], LODConfig(**CFG_KW), grid=GRID)


# ---------------------------------------------------------------------------
# render_lod_with_stats
# ---------------------------------------------------------------------------

def parity_plan(k_max, overflow, fused):
    stream = (StreamConfig(k_max=k_max, overflow=OverflowPolicy.CLAMP)
              if overflow == "clamp" else
              StreamConfig(k_max=max(k_max // 4, 4),
                           overflow=OverflowPolicy.SPILL,
                           max_spill_passes=4))
    return RenderPlan(grid=GRID,
                      test=TestConfig(method="cat", precision=MIXED,
                                      backend="cuda" if fused else "torch"),
                      stream=stream, raster=RasterConfig(fused=fused))


def test_select_all_bit_identical(built):
    """Footprint and mass tests off: selection is the conservative cluster
    cull, and the LOD frame equals the port's plain render of the whole
    scene bit for bit (image, alpha, work maps, entry_alive, counters) on
    every tile, under {CLAMP, SPILL} x {unfused, fused}. The fixture has no
    depth ties."""
    scene, lod = built["scene"], built["ref_lod"]
    cfg = LODConfig(**dict(CFG_KW, min_footprint_px=0.0, mass_floor=0.0))
    _, cam = cam_pair()
    assert len(torch.unique(scene.means[:, 2])) == scene.n
    k = measure_k_max(scene, [cam], grid=GRID, cap=scene.n)
    sel = select_clusters(lod, cam, cfg)
    n_sel = int(selected_members(lod, sel))
    assert n_sel < lod.n_real                 # the cull still drops clusters
    for overflow, fused in ((o, f) for o in ("clamp", "spill")
                            for f in (False, True)):
        plan = parity_plan(k, overflow, fused)
        out, c = quiet(plan.render_with_stats, scene, cam)
        lout, lc = quiet(dataclasses.replace(plan, lod=cfg)
                         .render_lod_with_stats, lod, cam)
        for name in out._fields:
            assert torch.equal(getattr(out, name), getattr(lout, name)), name
        assert set(lc) == set(c) | set(LOD_KEYS)
        for key in set(c) - {"n_gaussians", "cat_mask_bytes"}:
            assert torch.equal(c[key], lc[key]), key
        assert float(lc["lod_gaussians_selected"]) == n_sel
        if overflow == "spill":
            assert float(c["spill_passes"]) > 1


def test_lod_render_matches_reference(built):
    """Real selection: the LOD frame within 2e-4 of the reference's eager
    LOD render with the lod_* counters equal, at least 30 dB and SSIM
    (equal to the reference's metric) against the full frame; the facade
    and a derived bucket equal the pinned plan; a plan without lod raises
    the reference's error."""
    jscene, scene = built["jscene"], built["scene"]
    jl, lod = built["jl"], built["ref_lod"]
    jcfg, cfg = built["jcfg"], built["cfg"]
    jcam, cam = cam_pair()
    k = measure_k_max(scene, [cam], grid=GRID, cap=scene.n)
    plan = RenderPlan(grid=GRID, test=TestConfig(precision=MIXED),
                      stream=StreamConfig(k_max=k))
    jplan = JPlan(grid=JGRID, test=JTest(precision=J_MIXED),
                  stream=JStream(k_max=k))
    sel = select_clusters(lod, cam, cfg)
    bucket = selection_bucket_for(int(selected_members(lod, sel)), cfg,
                                  lod.n_padded)
    lplan = dataclasses.replace(
        plan, lod=dataclasses.replace(cfg, selection_bucket=bucket))
    out, counters = lplan.render_lod_with_stats(lod, cam)
    jout, jcounters = dataclasses.replace(
        jplan, lod=dataclasses.replace(jcfg, selection_bucket=bucket)
    ).render_lod_with_stats(jl, jcam)
    np.testing.assert_allclose(out.image.numpy(), np.asarray(jout.image),
                               rtol=0, atol=2e-4)
    for key in LOD_KEYS:
        assert float(counters[key]) == float(jcounters[key]), key
    assert 0.0 < float(counters["lod_selection_ratio"]) < 1.0
    assert float(counters["lod_bucket"]) == bucket
    full, _ = plan.render_with_stats(scene, cam)
    assert float(psnr(out.image, full.image)) >= 30.0
    jfull, _ = jplan.render_with_stats(jscene, jcam)
    assert float(psnr(out.image, full.image)) == pytest.approx(
        float(jpsnr(jout.image, jfull.image)), abs=0.05)
    got_ssim = float(ssim(out.image, full.image))
    assert got_ssim == pytest.approx(float(jssim(
        jax.numpy.asarray(out.image.numpy()),
        jax.numpy.asarray(full.image.numpy()))), abs=1e-5)
    assert 0.9 < got_ssim <= 1.0
    derived, dc = dataclasses.replace(plan, lod=cfg).render_lod_with_stats(
        lod, cam)
    facade, fc = Renderer.from_plan(lplan).render_lod_with_stats(lod, cam)
    for o in (derived, facade):
        for name in out._fields:
            assert torch.equal(getattr(o, name), getattr(out, name)), name
    assert float(dc["lod_bucket"]) == bucket
    with pytest.raises(ValueError) as want:
        JPlan(grid=JGRID).render_lod_with_stats(jl, jcam)
    with pytest.raises(ValueError) as got:
        RenderPlan(grid=GRID).render_lod_with_stats(lod, cam)
    assert str(got.value) == str(want.value)


def test_lod_span_tree_matches_reference(built):
    """An enabled tracer: `stage0_lod` then `render` at the root, the
    stage0_lod attributes equal to the reference's eager ones and the
    render tree's names and attribute keys the reference's."""
    jl, lod = built["jl"], built["ref_lod"]
    jcam, cam = cam_pair(0.4)
    plan = RenderPlan(grid=GRID, lod=built["cfg"],
                      stream=StreamConfig(k_max=64,
                                          overflow=OverflowPolicy.SPILL,
                                          max_spill_passes=2))
    jplan = JPlan(grid=JGRID, lod=built["jcfg"],
                  stream=JStream(k_max=64, overflow=JPolicy.SPILL,
                                 max_spill_passes=2))
    with juse_tracer(JTracer()) as jt:
        quiet(jplan.render_lod_with_stats, jl, jcam)
    with use_tracer(Tracer()) as t:
        quiet(plan.render_lod_with_stats, lod, cam)
    assert [r.name for r in t.roots] == [r.name for r in jt.roots] == \
        ["stage0_lod", "render"]
    (s0, root), (js0, jroot) = t.roots, jt.roots
    assert s0.attrs == js0.attrs
    assert s0.attrs["gaussians_selected"] > 0
    spans, jspans = list(root.walk()), list(jroot.walk())
    assert [s.name for s in spans] == [s.name for s in jspans]
    for s, js in zip(spans, jspans):
        assert set(s.attrs) - PORT_ONLY_ATTRS == set(js.attrs), s.name
    assert root.attrs["n_passes"] == jroot.attrs["n_passes"] == 2


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------

def test_engine_lod_serving(built, monkeypatch):
    """The engine's LOD path on the CPU, its k-means fed the reference's
    indices: per-frame lod_* counters equal to the reference engine's and
    frames within 2e-4 of them (the reference engine is jitted), the union
    charged as n_gaussians, the scene and telemetry gauges, a repeated
    batch a plan-cache hit and bit-identical, a plain scene at lod=None,
    and plan_for(lod_bucket=)."""
    jscene, scene = built["jscene"], built["scene"]
    probes = built["probes"]
    ref_idx = ref_init(scene.n, CFG_KW["num_clusters"])
    monkeypatch.setattr(clustering, "draw_init", lambda *a, **k: ref_idx)
    eng = RenderEngine(RenderPlan(grid=GRID), device="cpu", max_batch=4,
                       telemetry=Telemetry(registry=MetricsRegistry()))
    entry = eng.register_scene("city", scene,
                               probe_cameras=[p[1] for p in probes],
                               lod=built["cfg"])
    jeng = JEngine(JPlan(grid=JGRID), max_batch=4,
                   telemetry=JTelemetry(registry=JRegistry()))
    jentry = jeng.register_scene("city", jscene,
                                 probe_cameras=[p[0] for p in probes],
                                 lod=built["jcfg"])
    assert entry.lod is not None and entry.n_bucket == entry.lod.n_padded
    assert entry.k_max == jentry.k_max
    poses = [cam_pair(t) for t in (0.0, 0.35)]
    reqs = [RenderRequest("city", c[1], i) for i, c in enumerate(poses)]
    frames = quiet(eng.render_batch, reqs)
    jframes = quiet(jeng.render_batch,
                    [JRequest("city", c[0], i) for i, c in enumerate(poses)])
    for fr, jfr in zip(frames, jframes):
        for key in LOD_KEYS + ("n_gaussians",):
            assert float(fr.counters[key]) == float(jfr.counters[key]), key
        assert 0.0 < float(fr.counters["lod_selection_ratio"]) < 1.0
        assert float(fr.counters["n_gaussians"]) <= entry.n_real
        np.testing.assert_allclose(fr.image.numpy(), np.asarray(jfr.image),
                                   rtol=0, atol=2e-4)
    before = eng.compile_count
    again = quiet(eng.render_batch, reqs)
    assert eng.compile_count == before
    for a, b in zip(frames, again):
        assert torch.equal(a.image, b.image)
        for k in a.counters:
            assert torch.equal(a.counters[k], b.counters[k]), k
    reg = eng.telemetry.registry
    text = reg.expose()
    for name in ("engine_scene_lod_clusters", "engine_lod_selection_ratio",
                 "engine_lod_clusters_selected",
                 "engine_lod_gaussians_selected",
                 "render_lod_selection_ratio", "render_lod_clusters_selected",
                 "render_lod_gaussians_selected"):
        assert name in text, name
    jreg = jeng.telemetry.registry
    for name in ("engine_lod_selection_ratio", "engine_lod_clusters_selected",
                 "engine_lod_gaussians_selected"):
        assert reg.get(name).value(scene="city") == pytest.approx(
            jreg.get(name).value(scene="city"), rel=1e-6), name
    assert reg.get("engine_scene_lod_clusters").value(scene="city") == 24
    snap = eng.telemetry.snapshot()
    assert 0.0 < snap["counters"]["lod_selection_ratio"] < 1.0
    eng.register_scene("plain", ref_scene(200, seed=11)[1])
    assert eng.plan_for("plain", RES, RES).lod is None
    assert eng.plan_for("city", RES, RES,
                        lod_bucket=256).lod.selection_bucket == 256
    assert eng.plan_for("city", RES, RES).lod == built["cfg"]


def test_engine_lod_registration_errors(built):
    """The reference's messages: LOD needs probe cameras, and refuses an
    incremental engine."""
    jscene, scene = built["jscene"], built["scene"]
    jcam, cam = cam_pair()
    for j_kw, kw, reg in ((dict(), dict(), {}),
                          (dict(incremental=True), dict(incremental=True),
                           "probes")):
        jeng = JEngine(JPlan(grid=JGRID), **j_kw)
        eng = RenderEngine(RenderPlan(grid=GRID), device="cpu", **kw)
        probes = ((dict(probe_cameras=[jcam]), dict(probe_cameras=[cam]))
                  if reg == "probes" else ({}, {}))
        with pytest.raises(ValueError) as want:
            jeng.register_scene("city", jscene, lod=built["jcfg"],
                                **probes[0])
        with pytest.raises(ValueError) as got:
            eng.register_scene("city", scene, lod=built["cfg"], **probes[1])
        assert str(got.value) == str(want.value)
        assert "city" not in eng.scene_names()
