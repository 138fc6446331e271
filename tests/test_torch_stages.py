"""Parity of the PyTorch port's render stages with the JAX reference.

Each stage of `repro_torch` takes the reference's own upstream output (via
numpy and `repro_torch.convert`) and must reproduce the reference stage:

  project                    floats at rtol = atol = 1e-5; radius,
                             in_frustum and the eigen-quantities differ on
                             <= 0.5% of Gaussians (a 1-ulp difference can
                             move ceil(3σ))
  depth_order, compaction,   exact
  entry_subtile_mask,
  stream_entry_counters
  entry CAT                  FULL_FP32 exact, MIXED flip rate < 5e-4
  blend_pass                 colour/transmittance atol 2e-4, counters exact

plus the two faults measured in the port: fp8 overflow must give NaN (F1)
and the depth sort must be stable (F2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import camera as jcamera
from repro.core import cat as jcat
from repro.core import gaussians as jgauss
from repro.core import hierarchy as jhier
from repro.core import raster as jraster
from repro.core.precision import FULL_FP32 as J_FP32, MIXED as J_MIXED
from repro.core.precision import _quant as jquant

from repro_torch import convert
from repro_torch.core import camera as tcamera
from repro_torch.core import cat as tcat
from repro_torch.core import gaussians as tgauss
from repro_torch.core import hierarchy as thier
from repro_torch.core import raster as traster
from repro_torch.core.culling import TileGrid as TTileGrid
from repro_torch.core.precision import FULL_FP32, MIXED, _quant as tquant
from repro_torch.core.cat import SamplingMode as TMode
from repro.core.cat import SamplingMode as JMode

K_LIST = 256          # compacted list length of the stage tests


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
    return TTileGrid(grid64.height, grid64.width)


@pytest.fixture(scope="module")
def scenes(small_scene, wall_scene):
    """The fixture scenes padded with inert Gaussians (culled for every
    camera) to one count, so each eager reference op compiles once."""
    n = max(small_scene.n, wall_scene.n)
    return {"small_scene": jgauss.pad_scene(small_scene, n),
            "wall_scene": jgauss.pad_scene(wall_scene, n)}


@pytest.fixture(scope="module", params=["small_scene", "wall_scene"])
def case(request, scenes, cam64, grid64):
    """(reference Projected, port Projected, reference lists/valid/overflow
    of a K_LIST compaction) for one fixture scene."""
    scene = scenes[request.param]
    jproj = jgauss.project(scene, cam64)
    order, (lists, valid, overflow) = jax.jit(
        lambda p: (jraster.depth_order(p), jraster.compact_aabb_tile_lists(
            p, grid64, jraster.depth_order(p), K_LIST)))(jproj)
    return dict(scene=scene, jproj=jproj,
                tproj=convert.projected_from_numpy(fields(jproj)),
                order=order, lists=lists[0], valid=valid[0],
                overflow=overflow)


# ---------------------------------------------------------------------------
# F1 — fp8 overflow gives NaN, as the reference's float8_e4m3fn cast does
# ---------------------------------------------------------------------------

def test_quant_fp8_overflow_is_nan():
    edge = np.array([470, 500, 1e4, -600, np.inf, -np.inf, np.nan,
                     464, -464, 448, 463.9, 100.3, -0.013, 0.0], np.float32)
    got = tquant(torch.from_numpy(edge), "fp8").numpy()
    want = np.asarray(jquant(jnp.asarray(edge), "fp8"))
    np.testing.assert_array_equal(got, want)      # NaN positions included
    assert np.isnan(got[:7]).all()
    assert got[7] == 448.0 and got[8] == -448.0


@pytest.mark.parametrize("kind", ["fp16", "fp8"])
def test_quant_in_range_matches_reference(kind):
    x = (np.random.default_rng(0).standard_normal(20000) * 120).astype(
        np.float32)
    np.testing.assert_array_equal(
        tquant(torch.from_numpy(x), kind).numpy(),
        np.asarray(jquant(jnp.asarray(x), kind)))


# ---------------------------------------------------------------------------
# Preprocess
# ---------------------------------------------------------------------------

def test_cameras_match_reference():
    pairs = [(jcamera.orbit_camera(1.3, 96, 64),
              tcamera.orbit_camera(1.3, 96, 64)),
             (jcamera.resize_camera(jcamera.default_camera(64, 64), 32, 48),
              tcamera.resize_camera(tcamera.default_camera(64, 64), 32, 48))]
    for want, got in pairs:
        for name, w in fields(want).items():
            np.testing.assert_array_equal(np.asarray(getattr(got, name)), w,
                                          err_msg=name)


@pytest.mark.parametrize("scene_name", ["small_scene", "wall_scene"])
def test_project_matches_reference(scenes, scene_name, cam64):
    scene = scenes[scene_name]
    want = jgauss.project(scene, cam64)
    got = tgauss.project(convert.scene_from_numpy(fields(scene)),
                         convert.camera_from_numpy(fields(cam64)))
    for name in ("mean2d", "conic", "cov2d", "depth", "opacity", "color"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    n = scene.n
    # The eigen-quantities come from a closed form with a cancellation
    # (l1 - l2 = 2·sqrt(tr²/4 - det)), so an ulp of cov2d is amplified on
    # near-isotropic Gaussians: the eigenvalues and the axis ratio may miss
    # 1e-5 on <= 0.5% of them (as radius may); an eigenvector moves by
    # about |δΣ| / (l1 - l2), so its tolerance scales by l1 / (l1 - l2), and
    # it too may miss on <= 0.5% of them.
    for name in ("eigvals", "axis_ratio"):
        g = getattr(got, name).numpy().reshape(n, -1)
        w = np.asarray(getattr(want, name)).reshape(n, -1)
        off = ~np.isclose(g, w, rtol=1e-5, atol=1e-5).all(axis=1)
        assert off.sum() <= 0.005 * n, (name, int(off.sum()))
    ev = np.asarray(want.eigvals)
    cond = ev[:, 0] / np.maximum(ev[:, 0] - ev[:, 1], 1e-30)
    err = np.abs(got.eigvecs.numpy() - np.asarray(want.eigvecs)).max((1, 2))
    off = err > 1e-5 * np.maximum(cond, 1.0)
    assert off.sum() <= 0.005 * n, ("eigvecs", int(off.sum()))
    for name in ("radius", "in_frustum"):
        diff = np.sum(getattr(got, name).numpy()
                      != np.asarray(getattr(want, name)))
        assert diff <= 0.005 * n, (name, diff)


# ---------------------------------------------------------------------------
# Stage 1: depth order (F2) and the chunked AABB compaction
# ---------------------------------------------------------------------------

def test_depth_order_matches_reference(case):
    got = traster.depth_order(case["tproj"]).numpy()
    np.testing.assert_array_equal(got, np.asarray(case["order"]))


def test_depth_order_stable_under_ties(case):
    """F2: many equal depths, plus every culled Gaussian keyed at +inf,
    must keep the reference's (stable) index order."""
    rng = np.random.default_rng(1)
    jproj = case["jproj"]
    n = jproj.depth.shape[0]
    depth = np.round(np.asarray(jproj.depth) * 2) / 2        # heavy ties
    in_frustum = rng.random(n) < 0.6
    jproj = jproj._replace(depth=jnp.asarray(depth, jnp.float32),
                            in_frustum=jnp.asarray(in_frustum))
    want = np.asarray(jraster.depth_order(jproj))
    got = traster.depth_order(convert.projected_from_numpy(fields(jproj)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k_max,passes", [(64, 1), (64, 3)])
def test_compact_aabb_tile_lists_matches_reference(case, grid64, tgrid,
                                                   k_max, passes):
    want = jax.jit(jraster.compact_aabb_tile_lists, static_argnums=(1, 3, 4))(
        case["jproj"], grid64, case["order"], k_max, passes)
    got = traster.compact_aabb_tile_lists(case["tproj"], tgrid,
                                          t(case["order"]), k_max, passes)
    assert got[0].shape == (passes, tgrid.num_tiles, k_max)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool(got[2]) == bool(want[2])


# ---------------------------------------------------------------------------
# CTU: Stage-1 sub-tile bits, the entry CAT twin, the stream counters
# ---------------------------------------------------------------------------

def test_entry_subtile_mask_matches_reference(case, grid64, tgrid):
    want = jax.jit(jhier.entry_subtile_mask, static_argnums=1)(
        case["jproj"], grid64, case["lists"], case["valid"])
    got = thier.entry_subtile_mask(case["tproj"], tgrid, t(case["lists"]),
                                   t(case["valid"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prec", ["fp32", "mixed"])
def test_entry_cat_mask_matches_reference(case, grid64, tgrid, prec):
    """FULL_FP32 exact; MIXED within the 5e-4 tie-flip bound of the
    reference's jitted evaluation, and exact against its eager one (F4:
    under jit XLA drops some of Alg. 1's f16 round trips)."""
    jprec, tprec = {"fp32": (J_FP32, FULL_FP32),
                    "mixed": (J_MIXED, MIXED)}[prec]

    def ref(p, ls, v):
        return jcat.entry_cat_mask(p, grid64, ls, v, JMode.SMOOTH_FOCUSED,
                                   jprec)
    got = tcat.entry_cat_mask(case["tproj"], tgrid, t(case["lists"]),
                              t(case["valid"]), TMode.SMOOTH_FOCUSED,
                              tprec).numpy()
    want = np.asarray(jax.jit(ref)(case["jproj"], case["lists"],
                                   case["valid"]))
    flips = int(np.sum(got != want))
    if prec == "fp32":
        assert flips == 0
    else:
        assert flips < 5e-4 * want.size, flips
        eager = np.asarray(ref(case["jproj"], case["lists"], case["valid"]))
        np.testing.assert_array_equal(got, eager)


def test_stream_entry_counters_match_reference(case, grid64, tgrid):
    """Same inputs (the reference's per-entry hit counts) -> the same
    counters, exactly; and the full CTU stage under FULL_FP32."""
    jh = jax.jit(lambda p, ls, v, o: jhier.stream_entry_test(
        p, grid64, ls, v, o, JMode.SMOOTH_FOCUSED, J_FP32))(
        case["jproj"], case["lists"], case["valid"], case["overflow"])
    sub_hits = np.asarray(jnp.sum(jh.entry_sub_mask, axis=-1))
    mini_hits = np.asarray(jnp.sum(jh.entry_mini_mask, axis=-1))
    got = thier.stream_entry_counters(case["tproj"], tgrid, t(case["lists"]),
                                      t(case["valid"]), t(sub_hits),
                                      t(mini_hits), TMode.SMOOTH_FOCUSED)
    th = thier.stream_entry_test(case["tproj"], tgrid, t(case["lists"]),
                                 t(case["valid"]), t(case["overflow"]),
                                 TMode.SMOOTH_FOCUSED, FULL_FP32)
    np.testing.assert_array_equal(th.entry_mini_mask.numpy(),
                                  np.asarray(jh.entry_mini_mask))
    assert set(got) == set(jh.counters) == set(th.counters)
    for key, want in jh.counters.items():
        assert float(got[key]) == float(want), key
        assert float(th.counters[key]) == float(want), key


# ---------------------------------------------------------------------------
# Blend twin
# ---------------------------------------------------------------------------

def test_blend_pass_matches_reference(case, grid64, tgrid):
    mask = jax.jit(lambda p, ls, v, o: jhier.stream_entry_test(
        p, grid64, ls, v, o, JMode.SMOOTH_FOCUSED, J_MIXED).entry_mini_mask)(
        case["jproj"], case["lists"], case["valid"], case["overflow"])
    jstate, jalive = jax.jit(
        lambda p, ls, v, m: jraster.blend_pass(
            p, grid64, ls, v, m,
            jraster.init_blend_state(grid64.num_tiles, 256)))(
        case["jproj"], case["lists"], case["valid"], mask)
    tstate, talive = traster.blend_pass(
        case["tproj"], tgrid, t(case["lists"]), t(case["valid"]), t(mask),
        traster.init_blend_state(tgrid.num_tiles, 256))
    for name in ("rgb", "trans", "acc"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=0, atol=2e-4, err_msg=name)
    for name in ("processed", "blended"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)))
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
