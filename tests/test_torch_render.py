"""The port's render path end to end against the reference, and its serving
engine at a tiny size.

End to end: `Renderer.render_with_stats` with the "cuda" backends (on the
CPU, the kernels' plain versions) against the reference's per-frame
`Renderer(test=TestConfig(backend="pallas"), raster=RasterConfig(fused=True))`
render at 64², on both fixture scenes, under CLAMP (k_max 256, FULL_FP32)
and SPILL (k_max 128, 4 passes, MIXED). From the reference's own Projected:
image and alpha atol 2e-4 and the same counter keys; at FULL_FP32 the
integer counters and per-pixel work maps exactly, averaged counters at
rtol 1e-6; at MIXED the counters that no single CAT bit moves exactly, the
rest at rtol 1e-3 and the work maps on >= 99% of pixels (fault F4: the
reference's jitted Alg. 1 skips some fp16 roundings, flipping a few ties).
From the scene (projection included): image atol 2e-4, same counter keys.
"""
import dataclasses
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        RasterConfig as JRaster, Renderer as JRenderer,
                        StreamConfig as JStream, TestConfig as JTest)
from repro.core import pad_scene as jpad
from repro.core.precision import FULL_FP32 as J_FP32, MIXED as J_MIXED

from repro_torch import convert
from repro_torch.core import (FULL_FP32, MIXED, GridConfig, OverflowPolicy,
                              ProjectedScene, RasterConfig, Renderer,
                              StreamConfig, TestConfig, psnr)
from repro_torch.serving import (RenderEngine, RenderRequest, hd1080_cameras,
                                 hd1080_engine)

SIZE = 64
POLICIES = {
    "clamp": dict(k_max=256),
    "spill": dict(k_max=128, overflow="spill", max_spill_passes=4),
}
# CLAMP renders at FULL_FP32, where every CAT bit is reproducible; SPILL at
# MIXED, the serving precision (one compile per policy).
PRECISION = {"clamp": (FULL_FP32, J_FP32), "spill": (MIXED, J_MIXED)}
# Counters that are means over pixels or Gaussians (float sums in another
# order); every other counter is an integer count.
MEAN_COUNTERS = {"leader_tests_per_pair", "processed_per_pixel",
                 "blended_per_pixel"}
# Counters that do not depend on a single CAT bit: exact under MIXED too.
CAT_FREE_COUNTERS = {"n_gaussians", "n_frustum", "ctu_pairs",
                     "ctu_pairs_no_stage1", "ctu_prs", "leader_tests_per_pair",
                     "dup_tile", "dup_subtile", "vru_pairs_tile_aabb",
                     "cat_mask_bytes", "kblocks_total", "spill_passes"}


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


def port_renderer(policy, *, cuda_backends=True):
    return Renderer(
        grid=GridConfig(SIZE, SIZE),
        test=TestConfig(backend="cuda" if cuda_backends else "torch",
                        precision=PRECISION[policy][0]),
        stream=StreamConfig(**POLICIES[policy]),
        raster=RasterConfig(fused=cuda_backends))


def render_port(renderer, scene, camera):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # SPILL capacity warnings
        return renderer.render_with_stats(scene, camera)


@functools.lru_cache(maxsize=None)
def reference_render(policy):
    """Jitted reference render returning its own Projected too. Both scenes
    are padded to one Gaussian count, so each policy compiles once."""
    stream = dict(POLICIES[policy])
    if "overflow" in stream:
        stream["overflow"] = JPolicy(stream["overflow"])
    ref = JRenderer(grid=JGrid(SIZE, SIZE),
                    test=JTest(backend="pallas",
                               precision=PRECISION[policy][1]),
                    stream=JStream(**stream), raster=JRaster(fused=True))
    return jax.jit(lambda s, c: (ref.plan.preprocess(s, c).proj,
                                 ref.render_with_stats(s, c)))


@pytest.fixture(scope="module")
def scenes(small_scene, wall_scene):
    """The fixture scenes padded with inert Gaussians (culled for every
    camera: identical renders, one compile per policy)."""
    n = max(small_scene.n, wall_scene.n)
    return {"small_scene": jpad(small_scene, n),
            "wall_scene": jpad(wall_scene, n)}


@pytest.fixture(scope="module")
def port_inputs(scenes, cam64):
    return {name: (convert.scene_from_numpy(fields(s)),
                   convert.camera_from_numpy(fields(cam64)))
            for name, s in scenes.items()}


@pytest.mark.parametrize("policy", ["clamp", "spill"])
@pytest.mark.parametrize("scene_name", ["small_scene", "wall_scene"])
def test_render_matches_reference(scenes, port_inputs, cam64, scene_name,
                                  policy):
    jproj, (want, wc) = reference_render(policy)(scenes[scene_name], cam64)
    # The port's stages from the reference's own Projected: a 1-ulp
    # difference in `project` can flip a MIXED CAT bit at a tie.
    plan = port_renderer(policy).plan
    ps = ProjectedScene(convert.projected_from_numpy(fields(jproj)),
                        plan.grid.make())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, gc = plan._render_streams(ps, plan.stage1_compact(ps))

    for name in ("image", "alpha"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-4, err_msg=name)
    assert set(gc) == set(wc)
    assert bool(got.overflow) == bool(want.overflow)
    exact = PRECISION[policy][0] is FULL_FP32
    for name in ("processed_per_pixel", "blended_per_pixel", "entry_alive"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert np.mean(g != w) <= 0.01, name
    for key, w in wc.items():
        g, w = float(gc[key]), float(w)
        if key in MEAN_COUNTERS:
            np.testing.assert_allclose(g, w, rtol=1e-6 if exact else 1e-3,
                                       err_msg=key)
        elif exact or key in CAT_FREE_COUNTERS:
            assert g == w, key
        else:
            # MIXED: the reference evaluates Alg. 1 under jit, where XLA
            # drops some f16 round trips, so a few tie bits differ (F4).
            np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=key)

    if policy == "spill":
        # The whole entry point, projection included, from the scene.
        full, fc = render_port(port_renderer(policy),
                               *port_inputs[scene_name])
        np.testing.assert_allclose(full.image.numpy(),
                                   np.asarray(want.image), rtol=0, atol=2e-4)
        assert set(fc) == set(wc)


@pytest.mark.parametrize("cuda_backends", [False, True])
def test_spill_equals_one_pass_over_concatenation(port_inputs,
                                                  cuda_backends):
    """Four 128-entry spill passes render exactly like one 512-entry pass
    (the passes partition the capacity-sized list, and K = 128 is a K_BLK
    multiple for the fused blend)."""
    scene, cam = port_inputs["wall_scene"]
    spill = render_port(port_renderer("spill", cuda_backends=cuda_backends),
                        scene, cam)
    one = render_port(
        port_renderer("spill", cuda_backends=cuda_backends).replace(
            stream=StreamConfig(k_max=512)), scene, cam)
    assert float(spill[1]["spill_passes"]) > 1
    for a, b in zip(spill[0], one[0]):
        assert torch.equal(a, b)
    for key in ("vru_pairs", "ctu_prs", "ctu_stream_len", "vru_pairs_eff",
                "processed_per_pixel", "blended_per_pixel"):
        assert float(spill[1][key]) == float(one[1][key]), key


def test_hd1080_engine_serves_tiny_frames():
    """The 1080p serving configuration, shrunk to 64² and 2k Gaussians:
    SPILL passes through both kernel paths, each frame equal to the
    all-"torch" plan's render of the same camera."""
    engine, name = hd1080_engine(2048, width=SIZE, height=SIZE,
                                 k_max_pass=128, device="cpu")
    plan = engine.plan_for(name, SIZE, SIZE)
    assert plan.test.backend == "cuda" and plan.raster.fused
    assert plan.stream.overflow is OverflowPolicy.SPILL
    cams = hd1080_cameras(3, width=SIZE, height=SIZE)
    results = engine.render_batch(
        [RenderRequest(name, c, request_id=i) for i, c in enumerate(cams)])
    torch_plan = Renderer.from_plan(plan).replace(
        test=TestConfig(backend="torch"), raster=RasterConfig()).plan
    scene = engine.scene(name)
    for r, cam in zip(results, cams):
        assert r.image.shape == (SIZE, SIZE, 3)
        assert torch.isfinite(r.image).all() and not r.overflow
        assert r.passes_run == plan.n_passes
        assert 1 <= float(r.counters["spill_passes"]) <= plan.n_passes
        assert float(r.counters["n_gaussians"]) == 2048
        want, _ = torch_plan.render_with_stats(scene, cam)
        np.testing.assert_allclose(r.image.numpy(), want.image.numpy(),
                                   rtol=0, atol=2e-4)
        assert float(psnr(r.image, want.image)) > 60.0


def test_engine_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA"):
        RenderEngine(device="cuda")
