"""The last pieces of the PyTorch port's surface against the JAX reference,
and the port's examples and trace tools on the CPU.

  stream_hierarchical_test   lists, valid bits, both entry masks, overflow
                             and every counter equal to the reference's,
                             under FULL_FP32 and MIXED (the reference run
                             eagerly: its jitted MIXED CAT skips fp16
                             roundings, F4), every sampling mode
  the K1 route               `ops.stream_hierarchical_test_cuda` on CPU
                             tensors equal to the plain CAT, and to the
                             reference's Pallas route in interpret mode
  repro_torch.core           exports every name of `repro.core.__all__`
  examples, trace tools      each `main` returns 0 on the CPU at its
                             smallest flags, 2 without a card on its
                             default device, and the reference example's
                             claims hold; the port's and the reference's
                             trace2chrome write equal JSON

Scenes are the reference's `random_scene` (jax PRNG) at 64²; the
reference's `Projected` goes into the port's function.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import default_camera, project, random_scene
from repro.core import hierarchy as jhier
from repro.core.cat import SamplingMode as JMode
from repro.core.culling import TileGrid as JGrid
from repro.core.precision import FULL_FP32 as J_FP32, MIXED as J_MIXED
from repro.kernels import ops as jops

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.core import coherence, pipeline, raster
from repro_torch.core import hierarchy as thier
from repro_torch.core.cat import SamplingMode as TMode
from repro_torch.core.culling import TileGrid
from repro_torch.core.precision import FULL_FP32, MIXED
from repro_torch.kernels import ops as tops
from repro_torch.obs import Tracer, use_tracer, write_jsonl

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ("examples/torch_quickstart.py", "examples/torch_serve_render.py",
           "examples/torch_train_gaussians.py", "examples/torch_train_lm.py",
           "tools/torch_trace2chrome.py", "tools/torch_trace_smoke.py")
CASES = ((0, 123), (7, 400))          # (seed, n): test_stream.py's sweep
PRECS = ((J_FP32, FULL_FP32), (J_MIXED, MIXED))
FIELDS = ("lists", "valid", "entry_sub_mask", "entry_mini_mask", "overflow")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread keeps torch's
    worker threads from competing with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def projs() -> dict:
    """(seed, n) -> (the reference's Projected at 64², the port's copy).
    `project` is jitted, as in the reference's renders: op by op it costs
    seconds of compiles a scene size."""
    out, jproject = {}, jax.jit(project)
    for seed, n in CASES:
        jp = jproject(random_scene(jax.random.PRNGKey(seed), n),
                      default_camera(64, 64))
        out[seed, n] = jp, convert.projected_from_numpy(
            {f: np.asarray(getattr(jp, f)) for f in jp._fields})
    return out


def eager_reference(*args, **kw):
    """The reference's `stream_hierarchical_test`, op by op (F4)."""
    with jax.disable_jit():
        return jhier.stream_hierarchical_test(*args, **kw)


def assert_same(got, want):
    """A port `StreamHierarchyOut` equal to the reference's: every field
    and counter."""
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.counters.keys() == want.counters.keys()
    for k, v in want.counters.items():
        assert float(got.counters[k]) == float(v), k


def assert_same_port(got, want):
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.counters.keys() == want.counters.keys()
    assert all(torch.equal(got.counters[k], want.counters[k])
               for k in want.counters)


@pytest.mark.parametrize("seed,n", CASES)
def test_stream_hierarchical_test_matches_reference(projs, seed, n):
    jp, tp = projs[seed, n]
    for jprec, tprec in PRECS:
        for jmode, tmode in zip(JMode, TMode):
            want = eager_reference(jp, JGrid(64, 64), jmode, jprec, k_max=n)
            got = thier.stream_hierarchical_test(tp, TileGrid(64, 64), tmode,
                                                 tprec, k_max=n)
            assert not bool(got.overflow)
            assert_same(got, want)


def test_overflow_keeps_the_first_entries_and_order_is_optional(projs):
    """k_max below the longest list: overflow set, each tile's first k_max
    survivors in depth order, as the reference; a given depth order gives
    the same result as none."""
    jp, tp = projs[7, 400]
    grid = TileGrid(64, 64)
    full = thier.stream_hierarchical_test(tp, grid, k_max=400)
    longest = int(full.valid.sum(dim=1).max())
    k = longest // 2
    got = thier.stream_hierarchical_test(tp, grid, k_max=k)
    assert bool(got.overflow) and k < longest
    assert_same(got, eager_reference(jp, JGrid(64, 64), k_max=k))
    assert torch.equal(got.lists, full.lists[:, :k])
    assert torch.equal(got.valid, full.valid[:, :k])
    assert torch.equal(got.entry_mini_mask, full.entry_mini_mask[:, :k])
    ordered = thier.stream_hierarchical_test(
        tp, grid, k_max=k, order=raster.depth_order(tp))
    assert_same_port(ordered, got)


def test_cuda_route_on_cpu_matches_plain_and_reference_pallas(projs):
    """The K1 route on CPU tensors takes the plain CAT: equal to the
    default `cat_fn` on both scenes under both precisions, and to the
    reference's Pallas route (interpret mode) under FULL_FP32."""
    grid = TileGrid(64, 64)
    mode = TMode.SMOOTH_FOCUSED
    for seed, n in CASES:
        tp = projs[seed, n][1]
        for _, prec in PRECS:
            assert_same_port(
                tops.stream_hierarchical_test_cuda(tp, grid, mode, prec,
                                                   k_max=n),
                thier.stream_hierarchical_test(tp, grid, mode, prec,
                                               k_max=n))
    jp, tp = projs[0, 123]
    with jax.disable_jit():
        want = jops.stream_hierarchical_test_pallas(
            jp, JGrid(64, 64), JMode.SMOOTH_FOCUSED, J_FP32, k_max=123,
            interpret=True)
    assert_same(tops.stream_hierarchical_test_cuda(tp, grid, mode,
                                                   FULL_FP32, k_max=123),
                want)


def test_core_exports_cover_the_reference():
    assert set(jcore.__all__) <= set(tcore.__all__)
    assert all(hasattr(tcore, name) for name in tcore.__all__)
    assert tcore.render is pipeline.render
    assert tcore.render_with_stats is pipeline.render_with_stats
    assert tcore.stream_hierarchical_test is thier.stream_hierarchical_test
    assert tcore.tile_cover_rects is coherence.tile_cover_rects


def load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "example_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(rel: str, argv: list, **kw) -> int:
    """`main(argv)` of a script: 2 on its default device without a card,
    then its return code on the CPU."""
    main = load(rel).main
    if not torch.cuda.is_available():
        assert main(argv) == 2
    return main(argv + ["--device", "cpu"], **kw)


def test_quickstart_example_holds_the_reference_claims(tmp_path):
    report = {}
    trace = tmp_path / "trace.json"
    assert run_main("examples/torch_quickstart.py",
                    ["--fast", "--trace", str(trace)], report=report) == 0
    rows = report["designs"]
    cat, fused = rows["flicker-cat"], rows["flicker-fused"]
    assert all(math.isfinite(r["psnr"]) for r in rows.values())
    assert cat["work_px"] < rows["vanilla-aabb"]["work_px"]
    sweep = {"swept_per_pixel", "kblocks_processed", "kblocks_total"}
    assert {k: v for k, v in cat["counters"].items() if k not in sweep} == \
        {k: v for k, v in fused["counters"].items() if k not in sweep}
    assert fused["swept_px"] < cat["swept_px"] == report["k_max"]
    for f, c in zip(fused["results"], cat["results"]):
        assert float((f.image - c.image).abs().max()) <= 2e-4
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) == report["trace_spans"] > 0


def test_serve_render_example_answers_every_request():
    report = {}
    assert run_main("examples/torch_serve_render.py",
                    ["--requests", "4", "--gaussians", "300", "--res", "32",
                     "--pallas"], report=report) == 0
    results = report["results"]
    assert len(results) == 4
    assert all(bool(torch.isfinite(r.image).all()) for r in results)
    assert report["engine"].telemetry.total_frames == 4


def test_train_gaussians_example_fits_and_prunes():
    report = {}
    assert run_main("examples/torch_train_gaussians.py",
                    ["--steps", "3", "--size", "32", "--gaussians", "100"],
                    report=report) == 0
    assert report["losses"][-1] < report["losses"][0]
    assert report["n_pruned"] < report["n"] == 100
    assert math.isfinite(report["psnr"])


def test_train_lm_example_runs_the_driver(tmp_path, capsys):
    assert run_main("examples/torch_train_lm.py",
                    ["--steps", "2", "--ckpt-dir", str(tmp_path)]) == 0
    losses = re.findall(r"step\s+\d+ loss=(\S+)", capsys.readouterr().out)
    assert len(losses) == 2 and all(map(math.isfinite, map(float, losses)))


def test_trace_tools_match_the_reference(tmp_path):
    """The trace smoke passes on the CPU; on a JSONL the port's tracer
    wrote, the port's trace2chrome writes the reference's JSON."""
    assert run_main("tools/torch_trace_smoke.py",
                    ["--out", str(tmp_path / "smoke.json")]) == 0
    gen = torch.Generator().manual_seed(0)
    scene = tcore.random_scene(gen, 200)
    tracer = Tracer()
    with use_tracer(tracer):
        tcore.Renderer(grid=tcore.GridConfig(32, 32)).render_with_stats(
            scene, tcore.default_camera(32, 32))
    spans = tmp_path / "spans.jsonl"
    n = write_jsonl(tracer, spans)
    outs = {}
    for rel in ("tools/torch_trace2chrome.py", "tools/trace2chrome.py"):
        outs[rel] = tmp_path / (pathlib.Path(rel).stem + ".json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert load(rel).main([str(spans), str(outs[rel])]) == 0
    got, want = (json.loads(p.read_text()) for p in outs.values())
    assert got == want and len(got["traceEvents"]) == n
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert load("tools/torch_trace2chrome.py").main(
        [str(empty), str(tmp_path / "x.json")]) == 1


def test_scripts_import_without_jax_or_repro():
    """The six scripts and `repro_torch.core` import with `jax` and `repro`
    unimportable."""
    code = (
        "import importlib.util, sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.core\n"
        f"for rel in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        'x_' + rel.replace('/', '_')[:-3], rel)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
