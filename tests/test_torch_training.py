"""The port's scene training (`repro_torch.core.training`) against the JAX
reference's `core.training`.

Inputs are the reference's `random_scene` (the scene of its own gradient
tests in `test_spill.py`) carried across with numpy. Checked:

  loss_fn value and gradient     vs `jax.grad` of the reference's, under
                                 stream and dense x FULL_FP32 and MIXED:
                                 nonfinite masks equal, the rest within
                                 rtol 1e-4 and atol 1e-5 of the leaf's
                                 largest magnitude (float reassociation,
                                 e.g. SSIM's E[x²] - E[x]², leaves up to
                                 about 6e-6 of it on this scene)
  stream vs dense, SPILL vs      the port alone, at `test_spill.py`'s
  one pass                       tolerances
  _group_lrs, the Adam update    vs the reference's `train_step` arithmetic
                                 on a handed gradient with NaN and inf
                                 entries: within 1 ulp
  5 train_steps                  vs the reference's eager steps from one
                                 TrainState: scene within rtol 1e-4, m and
                                 v within rtol 1e-4 and atol 1e-5 of the
                                 leaf's largest magnitude, step equal
  train -> prune -> CAT render   `test_system.py`'s pipeline in miniature
  the plan guard                 plans that would launch a CUDA kernel are
                                 refused
  imports                        with `jax` and `repro` unimportable

The file holds 11 tests, so the tier-1 xdist queue starts it after
`test_stream_properties.py`.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.training as jtraining
from repro.core import (FULL_FP32 as J_FP32, MIXED as J_MIXED,
                        GridConfig as JGridConfig, RenderPlan as JRenderPlan,
                        StreamConfig as JStreamConfig,
                        TestConfig as JTestConfig)
from repro.core import default_camera as jdefault_camera
from repro.core import random_scene as jrandom_scene

from repro_torch import convert
from repro_torch.core import (FULL_FP32, MIXED, GridConfig, OverflowPolicy,
                              RasterConfig, RenderConfig, RenderPlan,
                              Renderer, StreamConfig, TestConfig,
                              default_camera, psnr)
from repro_torch.core import training
from repro_torch.core.cat import SamplingMode
from repro_torch.core.culling import TileGrid
from repro_torch.core.pruning import contribution_scores, prune

SIZE = 32
N = 250
LEAVES = training.SCENE_FIELDS


def fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def sinusoid(size: int) -> np.ndarray:
    """`benchmarks/train_dataflow.py`'s target image."""
    y, x = np.mgrid[0:size, 0:size] / size
    return np.stack([0.5 + 0.4 * np.sin(3 * x + 2 * y),
                     0.5 + 0.4 * np.cos(2 * y),
                     0.5 + 0.4 * np.sin(4 * x * y)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def jscene():
    return jrandom_scene(jax.random.PRNGKey(3), N, scale_range=(-2.9, -2.2),
                         stretch=4.0, opacity_range=(-1.5, 3.0),
                         spiky_frac=0.4)


@pytest.fixture(scope="module")
def scene(jscene):
    return convert.scene_from_numpy(fields(jscene))


@pytest.fixture(scope="module")
def cams():
    jcam = jdefault_camera(SIZE, SIZE)
    return jcam, convert.camera_from_numpy(fields(jcam))


def plans(dataflow: str, prec: str):
    jprec, tprec = {"fp32": (J_FP32, FULL_FP32),
                    "mixed": (J_MIXED, MIXED)}[prec]
    return (JRenderPlan(grid=JGridConfig(SIZE, SIZE),
                        test=JTestConfig(precision=jprec),
                        stream=JStreamConfig(k_max=N), dataflow=dataflow),
            RenderPlan(grid=GridConfig(SIZE, SIZE),
                       test=TestConfig(precision=tprec),
                       stream=StreamConfig(k_max=N), dataflow=dataflow))


def assert_leaf_close(got, want, rtol, scale_atol, name):
    """Nonfinite masks equal; finite entries within rtol and scale_atol x
    the largest finite magnitude of `want`."""
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=scale_atol * scale, err_msg=name)


def port_grads(plan, scene, cam, target):
    return training.value_and_grad(scene, cam, torch.from_numpy(target),
                                   plan, 0.2)


@pytest.mark.parametrize("prec", ["fp32", "mixed"])
@pytest.mark.parametrize("dataflow", ["stream", "dense"])
def test_loss_and_grad_match_reference(jscene, scene, cams, dataflow, prec):
    jplan, plan = plans(dataflow, prec)
    jcam, cam = cams
    target = sinusoid(SIZE)
    jloss, jgrads = jax.value_and_grad(jtraining.loss_fn)(
        jscene, jcam, jnp.asarray(target), jplan, 0.2)
    loss, grads = port_grads(plan, scene, cam, target)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for name in LEAVES:
        assert_leaf_close(getattr(grads, name).numpy(),
                          getattr(jgrads, name), 1e-4, 1e-5, name)
    assert float(grads.colors.abs().max()) > 0.0
    assert float(grads.means.abs().max()) > 0.0


def test_stream_grad_matches_dense(scene, cams):
    """`test_spill.py`'s stream/dense gradient parity on the port."""
    cam = cams[1]
    target = np.full((SIZE, SIZE, 3), 0.5, np.float32)
    _, g_s = port_grads(plans("stream", "fp32")[1], scene, cam, target)
    _, g_d = port_grads(plans("dense", "fp32")[1], scene, cam, target)
    for name in LEAVES:
        a, b = getattr(g_s, name), getattr(g_d, name)
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert float(g_s.colors.abs().max()) > 0.0


def test_spill_grad_matches_one_pass(scene, cams):
    """Gradients flow through the multi-pass SPILL fold (k_max 8 x 32
    passes) and equal the one-pass gradient (`test_spill.py`)."""
    cam = cams[1]
    target = np.full((SIZE, SIZE, 3), 0.5, np.float32)
    spill = Renderer(grid=GridConfig(SIZE, SIZE),
                     test=TestConfig(precision=MIXED),
                     stream=StreamConfig(k_max=8,
                                         overflow=OverflowPolicy.SPILL,
                                         max_spill_passes=32))
    one = RenderPlan(grid=GridConfig(SIZE, SIZE),
                     test=TestConfig(precision=MIXED),
                     stream=StreamConfig(k_max=256))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, g_s = port_grads(spill, scene, cam, target)
    _, g_1 = port_grads(one, scene, cam, target)
    for name in LEAVES:
        a, b = getattr(g_s, name), getattr(g_1, name)
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert float(g_s.colors.abs().max()) > 0.0


def test_group_lrs_and_adam_update_match_reference(monkeypatch):
    """The reference's own `train_step` arithmetic, fed a handed gradient
    (its `jax.value_and_grad` swapped for one that returns it), against the
    port's `adam_update`: every leaf within 1 ulp."""
    tc = training.TrainConfig()
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jtraining.TrainConfig())
    for step in (1.0, 7.0, 150.0, 30000.0):
        want = jtraining._group_lrs(jtraining.TrainConfig(),
                                    jnp.float32(step))
        got = training._group_lrs(tc, torch.tensor(step))
        np.testing.assert_array_max_ulp(got.means.numpy(),
                                        np.asarray(want.means), maxulp=1)
        for name in LEAVES[1:]:
            assert getattr(got, name) == getattr(want, name)

    rng = np.random.default_rng(7)
    shapes = dict(means=(40, 3), log_scales=(40, 3), quats=(40, 4),
                  opacity_logits=(40,), colors=(40, 3))

    def draw(scale=1.0, positive=False):
        out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
               for k, s in shapes.items()}
        return {k: np.abs(v) for k, v in out.items()} if positive else out

    d = dict(scene=draw(), m=draw(1e-2), v=draw(1e-4, positive=True),
             step=np.int32(6))
    g = draw(1e-2)
    g["means"][3, 1] = np.nan
    g["colors"][5, 0] = np.inf
    g["quats"][0, 2] = -np.inf
    g["opacity_logits"][9] = np.nan

    jstate = jtraining.TrainState(
        *(jtraining.GaussianScene(**{k: jnp.asarray(x)
                                     for k, x in d[p].items()})
          for p in ("scene", "m", "v")), jnp.asarray(d["step"]))
    jg = jtraining.GaussianScene(**{k: jnp.asarray(x) for k, x in g.items()})
    monkeypatch.setattr(jtraining, "jax", types.SimpleNamespace(
        value_and_grad=lambda f: lambda *a: (jnp.float32(0.0), jg),
        tree=jax.tree))
    jnew, _ = jtraining.train_step(jstate, None, None, None,
                                   jtraining.TrainConfig())

    state = convert.train_state_from_numpy(d)
    new = training.adam_update(state, convert.scene_from_numpy(g), tc)
    for part in ("scene", "m", "v"):
        for name in LEAVES:
            got = getattr(getattr(new, part), name)
            want = np.asarray(getattr(getattr(jnew, part), name))
            assert np.isfinite(want).all()
            np.testing.assert_array_max_ulp(got.detach().numpy(), want,
                                            maxulp=1)
    assert new.step.dtype == torch.int32 and int(new.step) == 7
    assert all(getattr(new.scene, n).is_leaf
               and getattr(new.scene, n).requires_grad for n in LEAVES)


def test_train_steps_track_reference(jscene, cams):
    """5 train_steps from one TrainState in each package (the reference
    eager, stream FULL_FP32)."""
    jplan, plan = plans("stream", "fp32")
    jcam, cam = cams
    target = sinusoid(SIZE)
    jstate = jtraining.init_state(jscene)
    state = convert.train_state_from_numpy(dict(
        scene=fields(jstate.scene), m=fields(jstate.m), v=fields(jstate.v),
        step=np.asarray(jstate.step)))
    tc, jtc = training.TrainConfig(), jtraining.TrainConfig()
    for _ in range(5):
        jstate, jloss = jtraining.train_step(jstate, jcam,
                                             jnp.asarray(target), jplan, jtc)
        state, loss = training.train_step(state, cam,
                                          torch.from_numpy(target), plan, tc)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    back = convert.train_state_to_numpy(state)
    assert back["step"] == np.asarray(jstate.step) == 5
    for name in LEAVES:
        np.testing.assert_allclose(back["scene"][name],
                                   np.asarray(getattr(jstate.scene, name)),
                                   rtol=1e-4, err_msg=name)
        for part in ("m", "v"):
            assert_leaf_close(back[part][name],
                              getattr(getattr(jstate, part), name),
                              1e-4, 1e-5, f"{part}.{name}")


def test_train_prune_cat_render_in_miniature():
    """`test_system.py`'s §V-A pipeline on the port: fit a scene to the
    render of a hidden one, prune it, render it with contribution-aware
    CAT under MIXED."""
    key = jax.random.PRNGKey(0)
    hidden = convert.scene_from_numpy(fields(jrandom_scene(
        key, 150, scale_range=(-2.5, -1.8), opacity_range=(0.0, 2.0))))
    scene0 = convert.scene_from_numpy(fields(jrandom_scene(
        jax.random.fold_in(key, 1), 250, scale_range=(-2.5, -1.8),
        opacity_range=(-1.0, 1.0))))
    cam = default_camera(SIZE, SIZE)

    def cfg(**kw):
        return RenderConfig(**dict(dict(height=SIZE, width=SIZE,
                                        method="aabb", precision=FULL_FP32,
                                        k_max=300), **kw))

    def render(s, c):
        with torch.no_grad():
            return c.to_plan().render(s, cam).image

    target = render(hidden, cfg())
    scene, losses = training.fit(scene0, cam, target, cfg(),
                                 training.TrainConfig(), steps=60)
    assert losses.shape == (60,) and losses.dtype == torch.float32
    assert float(losses[-1]) < float(losses[0])
    assert float(psnr(render(scene, cfg()), target)) > 15.0

    scores = contribution_scores(scene, [cam], TileGrid(SIZE, SIZE),
                                 k_max=250)
    pscene, _ = prune(scene, scores, keep_frac=0.7)
    assert pscene.n == int(250 * 0.7)
    ours = float(psnr(render(pscene, cfg(
        method="cat", mode=SamplingMode.SMOOTH_FOCUSED, precision=MIXED)),
        target))
    assert ours > float(psnr(render(pscene, cfg()), target)) - 1.5


def test_loss_fn_refuses_kernel_plans(scene, cams):
    """A plan that would launch a CUDA kernel (the "cuda" CTU, the fused
    blend) is refused: the kernels have no backward. On the CPU those
    wrappers run their differentiable plain versions, so without the guard
    such a plan would train here and fail on the card."""
    cam = cams[1]
    target = torch.full((SIZE, SIZE, 3), 0.5)
    grid = GridConfig(SIZE, SIZE)
    refused = [
        ("backend=.cuda", RenderPlan(grid=grid,
                                     test=TestConfig(backend="cuda"))),
        ("fused=True", Renderer(grid=grid, raster=RasterConfig(fused=True))),
        ("cuda.*fused", RenderConfig(height=SIZE, width=SIZE, use_cuda=True,
                                     fused=True)),
        ("PRTU kernels", RenderPlan(grid=grid, test=TestConfig(
            backend="cuda"), dataflow="dense")),
    ]
    for match, cfg in refused:
        with pytest.raises(ValueError, match=match) as err:
            training.loss_fn(scene, cam, target, cfg, 0.2)
        assert 'docs/kernels.md, "Differentiability"' in str(err.value)
        state = training.init_state(scene)
        with pytest.raises(ValueError, match="all-\"torch\" plan"):
            training.train_step(state, cam, target, cfg,
                                training.TrainConfig())
        with pytest.raises(ValueError, match="no backward"):
            training.fit(scene, cam, target, cfg, steps=1)
    with pytest.raises(TypeError, match="RenderPlan"):
        training.loss_fn(scene, cam, target, object(), 0.2)
    ok = Renderer(grid=grid, test=TestConfig(precision=FULL_FP32),
                  stream=StreamConfig(k_max=N))
    assert training.differentiable_plan(ok) is ok.plan
    assert bool(torch.isfinite(training.loss_fn(scene, cam, target, ok,
                                                0.2)))


def test_training_modules_import_without_jax(tmp_path):
    """core.training, checkpoint/, distributed.fault and convert import and
    fit two steps with `jax` and `repro` unimportable; the fit checkpoints
    and restores."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "import repro_torch, repro_torch.convert\n"
        "from repro_torch import checkpoint\n"
        "from repro_torch.core import training, default_camera, "
        "random_scene, RenderPlan, GridConfig\n"
        "from repro_torch.distributed import FaultConfig, FaultManager\n"
        "s = random_scene(torch.Generator().manual_seed(0), 24)\n"
        f"fm = FaultManager(FaultConfig(ckpt_dir={str(tmp_path)!r}, "
        "save_every=1, install_sigterm_hook=False))\n"
        "out, losses = training.fit(s, default_camera(16, 16), "
        "torch.full((16, 16, 3), 0.5), RenderPlan(grid=GridConfig(16, 16)), "
        "steps=2, fault=fm)\n"
        "assert losses.shape == (2,) and bool(torch.isfinite(losses).all())\n"
        "assert checkpoint.latest_step(fm.cfg.ckpt_dir) == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
