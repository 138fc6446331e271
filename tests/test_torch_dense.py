"""The port's dense-mask oracle, the AABB/OBB baselines and the two dense
kernels' plain versions against the JAX reference, on the CPU.

Each port function takes the reference's own inputs (numpy, then
`repro_torch.convert`) and must reproduce the reference at 64² on the
fixture scenes of `tests/conftest.py`. Tolerances:

  TileGrid image-global layout, obb/aabb masks,     exact
  hierarchical_test masks and counters (FULL_FP32),
  baseline masks and counters, dense compaction,
  entry_mask_from_dense, exact_minitile_mask
  minitile_cat_mask                 FULL_FP32 exact in every sampling
                                    mode, blocked or not; MIXED exact
                                    against the reference's eager path,
                                    flip rate < 5e-4 against its jitted one
                                    (fault F4: under jit XLA drops some of
                                    Alg. 1's fp16 round trips)
  K4's plain version                exact against the reference's Pallas
                                    kernel (interpret mode) at FULL_FP32,
                                    MIXED, FULL_FP8 and default arguments;
                                    K1's default arguments are the
                                    reference's (same mask)
  K3's plain version                rgb/trans atol 1e-5 against the Pallas
                                    kernel, whose in-block cumprod
                                    rounds differently from the fold
  dense / aabb / obb plans          image atol 2e-4 (the reference's fused
                                    blend stops below T_EPS, its jnp blend
                                    is a scan), same counter keys, counters
                                    exact (FULL_FP32)
  render_reference                  atol 1e-5 (the same cumprod)
  port stream == port dense         bit for bit, every shared counter
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cat as jcat
from repro.core import culling as jculling
from repro.core import hierarchy as jhier
from repro.core import raster as jraster
from repro.core import (GridConfig as JGrid, RasterConfig as JRaster,
                        Renderer as JRenderer, StreamConfig as JStream,
                        TestConfig as JTest)
from repro.core.cat import SamplingMode as JMode
from repro.core.precision import FULL_FP32 as J_FP32, MIXED as J_MIXED
from repro.kernels import prtu as jprtu
from repro.kernels import render as jrender

from repro_torch import convert
from repro_torch.core import (FULL_FP32, FULL_FP8, MIXED, GridConfig,
                              PrecisionScheme, ProjectedScene, RasterConfig, Renderer,
                              StreamConfig, TestConfig, measure_k_max)
from repro_torch.core import cat as tcat
from repro_torch.core import culling as tculling
from repro_torch.core import hierarchy as thier
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import raster as traster
from repro_torch.core.cat import SamplingMode as TMode
from repro_torch.kernels import prtu, render

from test_torch_cuda import (BLEND_CASES, blend_case_operands,
                             blend_operands, cat_operands, dense_cat_operands,
                             far_band_operands, far_pair_masks, prec_kw)

SIZE = 64
MODES = ["uniform_dense", "uniform_sparse", "smooth_focused",
         "spiky_focused"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps torch's
    worker threads from competing with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    names = ([f.name for f in dataclasses.fields(obj)]
             if dataclasses.is_dataclass(obj) else obj._fields)
    return {n: np.asarray(getattr(obj, n)) for n in names}


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def tgrid(grid64):
    return tculling.TileGrid(grid64.height, grid64.width)


@pytest.fixture(scope="module")
def tproj(proj64):
    return convert.projected_from_numpy(fields(proj64))


# ---------------------------------------------------------------------------
# Layout and region tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_tile_grid_global_layout_matches_reference(shape):
    jg, tg = jculling.TileGrid(*shape), tculling.TileGrid(*shape)
    assert (tg.num_subtiles, tg.num_minitiles) == (jg.num_subtiles,
                                                   jg.num_minitiles)
    pairs = [("subtile_of_minitile", ()), ("global_minitile_ids", ()),
             ("global_subtile_ids", ()), ("minitile_origins", ()),
             ("subtile_origins", ())]
    for size in (16, 8, 4):
        pairs += [("region_origins", (size,)), ("tile_of_region", (size,)),
                  ("global_region_ids", (size,))]
    # One compile for the whole reference layout (its eager ops would
    # compile one by one).
    want = jax.jit(lambda: [getattr(jg, name)(*args)
                            for name, args in pairs])()
    for (name, args), w in zip(pairs, want):
        np.testing.assert_array_equal(getattr(tg, name)(*args).numpy(),
                                      np.asarray(w), err_msg=f"{name}{args}")


@pytest.mark.parametrize("method", ["aabb", "obb"])
def test_intersection_masks_match_reference(proj64, grid64, tproj, tgrid,
                                            method, monkeypatch):
    """Every level, then every level again by blocks of 8 regions."""
    levels = ("tile", "subtile", "minitile")
    want = jax.jit(lambda p: [jculling.intersection_mask(p, grid64, method,
                                                         level)
                              for level in levels])(proj64)
    for block in (None, 8):
        if block:
            monkeypatch.setattr(tculling, "REGION_CHUNK_ELEMS",
                                block * tproj.depth.shape[0])
        for level, w in zip(levels, want):
            got = tculling.intersection_mask(tproj, tgrid, method, level)
            np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                          err_msg=f"{level}, block {block}")


# ---------------------------------------------------------------------------
# Dense CAT: minitile_cat_mask and K4's plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_cat(proj64, grid64):
    """The reference's minitile_cat_mask per (mode, precision, jit), each
    evaluated once for the module; the jitted ones of every mode in one
    compile."""
    def fn(mode: str, prec: str):
        return functools.partial(
            jcat.minitile_cat_mask, grid=grid64, mode=JMode(mode),
            prec={"fp32": J_FP32, "mixed": J_MIXED}[prec])

    @functools.lru_cache(maxsize=None)
    def jitted(prec: str):
        return dict(zip(MODES, jax.jit(lambda p: [fn(m, prec)(p)
                                                  for m in MODES])(proj64)))

    @functools.lru_cache(maxsize=None)
    def get(mode: str, prec: str, jit: bool):
        return np.asarray(jitted(prec)[mode] if jit else
                          fn(mode, prec)(proj64))
    return get


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_minitile_cat_mask_matches_reference(tproj, tgrid, reference_cat,
                                             mode, blocked, monkeypatch):
    if blocked:       # (M, 100, 4) weight blocks: 8 blocks of 100 Gaussians
        monkeypatch.setattr(tcat, "GAUSS_CHUNK_ELEMS",
                            100 * 4 * tgrid.num_minitiles)
    for prec, tprec in (("fp32", FULL_FP32), ("mixed", MIXED)):
        got = tcat.minitile_cat_mask(tproj, tgrid, TMode(mode),
                                     tprec).numpy()
        np.testing.assert_array_equal(got, reference_cat(mode, prec, False))
        if prec == "mixed":
            jitted = reference_cat(mode, prec, True)
            assert np.sum(got != jitted) < 5e-4 * got.size


@pytest.mark.parametrize("prec", ["fp32", "mixed", "fp8", "default"])
def test_dense_cat_plain_matches_pallas_kernel(prec):
    ops = dense_cat_operands(7, m=128, n=256)
    kw = (dict(mode="smooth_focused") if prec == "default" else
          dict(mode="spiky_focused", **prec_kw(
              {"fp32": FULL_FP32, "mixed": MIXED, "fp8": FULL_FP8}[prec])))
    want = np.asarray(jprtu.prtu_cat_mask(*(jnp.asarray(x) for x in ops),
                                          interpret=True, **kw))
    got = prtu.prtu_cat_mask(*(t(x) for x in ops), **kw)
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prec", ["mixed", "fp32", "fp8", "fp8_delta"])
def test_dense_cat_far_band_matches_pallas_kernel(prec):
    """K4's operands on a 1024-px-wide band of leaders with Gaussians whose
    deltas straddle +-464 px in x, in y and in both: the plain version
    equals the reference's Pallas kernel, and the premise of K4's fp8
    overflow skip holds. Under a fp8 delta no pair hits whose two x deltas,
    or two y deltas, pass 464 (NaN in e4m3); with wide products
    (fp8_delta) pairs where only one delta of an axis passes it do hit;
    under FULL_FP32 pairs beyond 464 px hit."""
    p = {"mixed": MIXED, "fp32": FULL_FP32, "fp8": FULL_FP8,
         "fp8_delta": PrecisionScheme("fp32", "fp8", "fp32", "fp32")}[prec]
    ops = far_band_operands(21)
    kw = dict(mode="uniform_dense", **prec_kw(p))
    m, n = ops[0].shape[0], ops[2].shape[0]
    want = np.asarray(jprtu.prtu_cat_mask(*(jnp.asarray(x) for x in ops),
                                          interpret=True, **kw))[:m, :n]
    got = prtu.prtu_cat_mask(*(t(x) for x in ops), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    both, one = far_pair_masks(ops, p.coord)
    live = np.isfinite(ops[4])[None, :]
    assert (both & live).any()
    if p.delta == "fp8":
        assert not got[both].any()
    if prec == "fp8_delta":
        assert (one & live).any() and got[one & live].any()
    if prec == "fp32":
        assert got[both & live].any()


def test_entry_cat_default_precision_matches_reference():
    """K1's wrapper with every precision argument left at its default
    computes the reference's default mask (mul_prec "fp8")."""
    ops = cat_operands(8, t=2, k=128)
    want = np.asarray(jprtu.prtu_entry_cat_mask(
        *(jnp.asarray(x) for x in ops), interpret=True))
    got = prtu.prtu_entry_cat_mask(*(t(x) for x in ops)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Dense hierarchy, baselines, compaction, entry gather
# ---------------------------------------------------------------------------

def test_hierarchical_test_matches_reference(proj64, grid64, tproj, tgrid,
                                             monkeypatch):
    """Masks and every counter exact at FULL_FP32, with the Stage-1 gate
    and the counts taken by blocks of 16 mask rows."""
    monkeypatch.setattr(thier, "COUNT_CHUNK_ELEMS",
                        16 * tproj.depth.shape[0])
    want = jax.jit(lambda p: jhier.hierarchical_test(
        p, grid64, JMode.SMOOTH_FOCUSED, J_FP32))(proj64)
    got = thier.hierarchical_test(tproj, tgrid, TMode.SMOOTH_FOCUSED,
                                  FULL_FP32)
    for name in ("tile_mask", "minitile_mask", "subtile_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert set(got.counters) == set(want.counters)
    for key, w in want.counters.items():
        assert float(got.counters[key]) == float(w), key


@pytest.mark.parametrize("method", ["aabb", "obb"])
def test_baseline_masks_match_reference(proj64, grid64, tproj, tgrid,
                                        method):
    want = jax.jit(lambda p: jhier.baseline_masks(p, grid64, method))(
        proj64)
    got = thier.baseline_masks(tproj, tgrid, method)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if method == "aabb":
        assert got[1] is None and want[1] is None
    else:   # the port keeps the (S, N) sub-tile mask the reference expands
        np.testing.assert_array_equal(
            got[1][tgrid.subtile_of_minitile()].numpy(), np.asarray(want[1]))
    assert {k: float(v) for k, v in got[2].items()} == \
        {k: float(v) for k, v in want[2].items()}


@pytest.fixture(scope="module")
def reference_compaction(proj64, grid64):
    """The reference's Stage-1 tile mask (OR of the sub-tile AABBs), depth
    order, and its compaction into 64-entry lists in 1 and 3 passes."""
    def fn(p):
        sub = jculling.aabb_mask(p, grid64.subtile_origins(), grid64.subtile)
        mask = jax.ops.segment_sum(
            sub.astype(jnp.int32), grid64.tile_of_region(grid64.subtile),
            num_segments=grid64.num_tiles) > 0
        order = jraster.depth_order(p)
        return mask, order, {n: jraster.compact_tile_lists_passes(
            mask, order, 64, n) for n in (1, 3)}
    return jax.jit(fn)(proj64)


@pytest.mark.parametrize("passes", [1, 3])
def test_compact_and_gather_dense_match_reference(tgrid, grid64,
                                                  reference_compaction,
                                                  reference_cat, passes):
    """The dense compaction of the Stage-1 tile mask, and the CAT mask
    gathered at its entries."""
    mask, order, lists = reference_compaction
    want = lists[passes]
    got = (traster.compact_tile_lists_passes(t(mask), t(order), 64, passes)
           if passes > 1 else
           [x[None] if x.ndim else x
            for x in traster.compact_tile_lists(t(mask), t(order), 64)])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cat = reference_cat("smooth_focused", "fp32", False)
    lists = np.asarray(want[0][passes - 1])
    np.testing.assert_array_equal(
        traster.entry_mask_from_dense(tgrid, t(cat), t(lists)).numpy(),
        np.asarray(jraster.entry_mask_from_dense(grid64, cat, lists)))


# ---------------------------------------------------------------------------
# K3's plain version, the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", BLEND_CASES)
def test_full_blend_plain_matches_pallas_kernel(case):
    """K3's plain version on the lists K3 must handle: full and sparse
    masks, one bit an entry, invalid slots between valid ones, a tile with
    no valid slot, and K not a multiple of K_BLK."""
    ops = blend_case_operands(case, 9, t=4, k=128)
    want = jrender.blend_tiles(*(jnp.asarray(x) for x in ops),
                               interpret=True)
    got = render.blend_tiles(*(t(x) for x in ops))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_oracles_at_32px(small_scene):
    """render_reference, exact_minitile_mask and the dense CAT / full-sweep
    oracles of `kernels.ref` against the reference's."""
    from repro.core import camera as jcamera, gaussians as jgauss
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    jg = jculling.TileGrid(32, 32)
    tg = tculling.TileGrid(32, 32)
    cat_ops = dense_cat_operands(10, m=64, n=256)
    blend_ops = blend_operands(11, t=4, k=128)
    jp, image, exact, cat, blend = jax.jit(lambda s, c, cops, bops: (
        (p := jgauss.project(s, c)), jraster.render_reference(p, jg, 0.25),
        jcat.exact_minitile_mask(p, jg), jref.prtu_cat_mask_ref(*cops),
        jref.blend_tiles_ref(*bops)))(
        small_scene, jcamera.default_camera(32, 32), cat_ops, blend_ops)
    tp = convert.projected_from_numpy(fields(jp))
    np.testing.assert_allclose(
        traster.render_reference(tp, tg, 0.25).numpy(), np.asarray(image),
        rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcat.exact_minitile_mask(tp, tg).numpy(),
                                  np.asarray(exact))
    np.testing.assert_array_equal(
        tref.prtu_cat_mask_ref(*(t(x) for x in cat_ops)).numpy(),
        np.asarray(cat))
    for g, w in zip(tref.blend_tiles_ref(*(t(x) for x in blend_ops)), blend):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Plans: dense oracle and baselines against the reference; stream == dense
# ---------------------------------------------------------------------------

PLANS = {                   # name: (method, dataflow, fused)
    "dense": ("cat", "dense", False),
    "dense-fused": ("cat", "dense", True),
    "aabb": ("aabb", "stream", True),
    "obb": ("obb", "stream", False),
}


@pytest.fixture(scope="module")
def reference_plans(small_scene, cam64):
    """The reference's Projected and its (RenderOut, counters) under every
    plan of PLANS, in one compile."""
    refs = {}
    for name, (method, dataflow, fused) in PLANS.items():
        refs[name] = JRenderer(grid=JGrid(SIZE, SIZE),
                               test=JTest(method=method, precision=J_FP32),
                               stream=JStream(k_max=128),
                               raster=JRaster(fused=fused),
                               dataflow=dataflow)
    return jax.jit(lambda s, c: (
        refs["dense"].plan.preprocess(s, c).proj,
        {name: r.render_with_stats(s, c) for name, r in refs.items()}))(
            small_scene, cam64)


def port_plan(name, precision=FULL_FP32, backend="cuda", k_max=128):
    method, dataflow, fused = PLANS[name]
    return Renderer(grid=GridConfig(SIZE, SIZE),
                    test=TestConfig(method=method, precision=precision,
                                    backend=backend),
                    stream=StreamConfig(k_max=k_max),
                    raster=RasterConfig(fused=fused),
                    dataflow=dataflow).plan


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_matches_reference(reference_plans, name):
    """From the reference's own Projected; the "cuda" backend, whose
    kernels' plain versions run here."""
    jproj, renders = reference_plans
    want, wc = renders[name]
    plan = port_plan(name)
    ps = ProjectedScene(convert.projected_from_numpy(fields(jproj)),
                        plan.grid.make())
    got, gc = plan._render_streams(ps, plan.stage1_compact(ps))
    for f in ("image", "alpha"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=2e-4, err_msg=f)
    np.testing.assert_array_equal(got.entry_alive.numpy(),
                                  np.asarray(want.entry_alive))
    assert set(gc) == set(wc)
    for key, w in wc.items():
        assert float(gc[key]) == float(w), key


@pytest.mark.parametrize("fused,passes", [(False, 1), (True, 1), (True, 4)])
def test_port_stream_equals_port_dense(small_scene, cam64, fused, passes):
    """The stream contract inside the port, at MIXED: identical lists and
    per-entry masks, hence bit-identical images and every shared counter
    (cat_mask_bytes differs by design), in one pass or in SPILL passes
    (where the stream's per-pass counters add up and the dense ones are
    the frame's)."""
    args = (convert.scene_from_numpy(fields(small_scene)),
            convert.camera_from_numpy(fields(cam64)))
    # The probed list bound: no tile overflows, and the plain blends loop
    # over no more slots than that.
    k_max = measure_k_max(args[0], [args[1]], grid=GridConfig(SIZE, SIZE))
    plan = dataclasses.replace(
        port_plan("dense-fused", MIXED, k_max=k_max // passes),
        raster=RasterConfig(fused=fused))
    if passes > 1:
        plan = dataclasses.replace(plan, stream=StreamConfig(
            k_max=k_max // passes, overflow="spill",
            max_spill_passes=passes))
    out_d, c_d = plan.render_with_stats(*args)
    out_s, c_s = dataclasses.replace(plan, dataflow="stream") \
        .render_with_stats(*args)
    assert not bool(out_s.overflow)
    assert torch.equal(out_s.image, out_d.image)
    assert torch.equal(out_s.entry_alive, out_d.entry_alive)
    assert set(c_s) == set(c_d)
    for key in set(c_s) - {"cat_mask_bytes"}:
        assert float(c_s[key]) == float(c_d[key]), key
    assert (float(c_s["spill_passes"]) > 1) == (passes > 1)
    assert float(c_d["cat_mask_bytes"]) == (16 * 4 + 16 * 16) * small_scene.n


def test_render_config_shim(small_scene, cam64):
    """RenderConfig <-> RenderPlan round trip; the deprecated entry points
    warn and return the plan's render unchanged; the three paper
    configurations map onto their methods."""
    cfg = tpipeline.RenderConfig(height=SIZE, width=SIZE, method="obb",
                                 dataflow="stream", k_max=256, use_cuda=True,
                                 fused=True, background=0.5)
    plan = cfg.to_plan()
    assert plan.test.backend == "cuda" and plan.raster.fused
    assert tpipeline.RenderConfig.from_plan(plan) == cfg
    assert cfg.to_renderer().plan == plan
    assert tpipeline.VANILLA_CONFIG.to_plan().test.method == "aabb"
    assert tpipeline.GSCORE_CONFIG.to_plan().test.method == "obb"
    assert tpipeline.FLICKER_CONFIG.to_plan().test.method == "cat"
    args = (convert.scene_from_numpy(fields(small_scene)),
            convert.camera_from_numpy(fields(cam64)))
    want, wc = plan.render_with_stats(*args)
    with pytest.warns(DeprecationWarning):
        got, gc = tpipeline.render_with_stats(*args, cfg)
    with pytest.warns(DeprecationWarning):
        image = tpipeline.render(*args, cfg).image
    assert torch.equal(got.image, want.image)
    assert torch.equal(image, want.image)
    assert {k: float(v) for k, v in gc.items()} == \
        {k: float(v) for k, v in wc.items()}
    with pytest.raises(ValueError, match="dataflow"):
        dataclasses.replace(plan, dataflow="sparse")
    with pytest.raises(ValueError, match="method"):
        TestConfig(method="ellipse")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg.to_renderer()                # the migration path does not warn
