"""The port's observability: span tracing, the metrics registry and the
exporters, against the JAX reference at 32 px.

An enabled tracer around the port's eager render yields the reference's
eager span tree — `render -> preprocess, stage1_compact, ctu[pass=i],
blend[pass=i], finalize` — with the same attribute keys and pass indices
for the same plan and scene, and numbers within 1% (the two packages'
projections differ by an ulp on a few Gaussians, which moves list
entries); in the port the ctu and blend deltas sum to the frame's
counters, on the fused path too. A disabled tracer leaves renders bit
identical, `plan_first_call` fires once per plan, the tracer is restored
after use, the Prometheus text equals the reference's for the same
operations, and the JSONL and Chrome files round-trip with the
reference's record schema. A subprocess imports the port's serving and
obs packages with `jax` and `repro` blocked.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        Renderer as JRenderer, StreamConfig as JStream)
from repro.core import default_camera as jdefault_camera
from repro.core import random_scene as jrandom_scene
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Tracer as JTracer, span_records as jspan_records
from repro.obs import use_tracer as juse_tracer

from repro_torch import convert
from repro_torch.core import (GridConfig, OverflowPolicy, RasterConfig,
                              Renderer, StreamConfig, TestConfig,
                              orbit_camera, stack_cameras)
from repro_torch.obs import (MetricsRegistry, NoopTracer, Tracer,
                             chrome_trace, current, read_jsonl,
                             span_records, use_tracer, write_chrome_trace,
                             write_jsonl)
from repro_torch.serving import RenderEngine, RenderRequest, Telemetry

SIZE = 32
# Stage attributes the port adds to the reference's.
PORT_ONLY_ATTRS = {"frames"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def spill_scene():
    """The reference's SPILL smoke scene, and its conversion."""
    scene = jrandom_scene(jax.random.PRNGKey(3), 700,
                          scale_range=(-2.5, -2.0), stretch=4.0,
                          opacity_range=(-2.0, 3.5))
    return scene, convert.scene_from_numpy(fields(scene))


@pytest.fixture(scope="module")
def cam():
    jcam = jdefault_camera(SIZE, SIZE)
    return jcam, convert.camera_from_numpy(fields(jcam))


def spill_renderer(k_max=64, passes=3, fused=False):
    return Renderer(
        grid=GridConfig(SIZE, SIZE),
        test=TestConfig(backend="cuda" if fused else "torch"),
        stream=StreamConfig(k_max=k_max, overflow=OverflowPolicy.SPILL,
                            max_spill_passes=passes),
        raster=RasterConfig(fused=fused))


def render_quiet(renderer, scene, camera):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return renderer.render_with_stats(scene, camera)


def test_span_tree_matches_reference(spill_scene, cam):
    """Same plan, same scene and camera: the same tree, attribute keys and
    pass indices as the reference's eager render, numbers within 1%."""
    ref = JRenderer(grid=JGrid(SIZE, SIZE),
                    stream=JStream(k_max=64, overflow=JPolicy.SPILL,
                                   max_spill_passes=3))
    with juse_tracer(JTracer()) as jt, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.render_with_stats(spill_scene[0], cam[0])
    with use_tracer(Tracer()) as t:
        render_quiet(spill_renderer(), spill_scene[1], cam[1])
    (jroot,), (root,) = jt.roots, t.roots
    assert int(root.attrs["n_passes"]) == 3
    jspans, spans = list(jroot.walk()), list(root.walk())
    assert [s.name for s in spans] == [s.name for s in jspans]
    assert [c.name for c in root.children] == (
        ["preprocess", "stage1_compact"] + ["ctu"] * 3 + ["blend"] * 3
        + ["finalize"])
    for s, js in zip(spans, jspans):
        assert set(s.attrs) - PORT_ONLY_ATTRS == set(js.attrs), s.name
        for k, jv in js.attrs.items():
            v = s.attrs[k]
            if k in ("backend", "traced"):
                continue            # "torch"/"cuda" for "jnp"/"pallas"
            if isinstance(jv, (bool, str)) or k in ("pass", "k_max"):
                assert v == jv, (s.name, k)
            elif isinstance(jv, list):
                np.testing.assert_allclose(v, jv, rtol=1e-2, err_msg=k)
            else:
                assert v == pytest.approx(jv, rel=1e-2, abs=1e-6), \
                    (s.name, k)
        assert s.t1 >= s.t0
    assert root.attrs["traced"] is False
    for c in root.children:
        assert c.parent_id == root.span_id
    # the reference's JSONL record schema
    assert [set(r) for r in span_records(t)] == \
        [set(r) for r in jspan_records(jt)]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_counter_deltas_sum_to_frame(spill_scene, cam, fused):
    with use_tracer(Tracer()) as t:
        out, counters = render_quiet(spill_renderer(fused=fused),
                                     spill_scene[1], cam[1])
    (root,) = t.roots
    vru = sum(s.attrs["vru_pairs"] for s in root.find("ctu"))
    assert vru == pytest.approx(float(counters["vru_pairs"]), rel=1e-6)
    proc = sum(s.attrs["processed_delta"] for s in root.find("blend"))
    blend = sum(s.attrs["blended_delta"] for s in root.find("blend"))
    assert proc == float(out.processed_per_pixel.sum(dtype=torch.float64))
    assert blend == float(out.blended_per_pixel.sum(dtype=torch.float64))
    assert root.attrs["processed_per_pixel"] == \
        pytest.approx(proc / SIZE ** 2, rel=1e-5)
    assert [s.attrs["backend"] for s in root.find("blend")] == \
        ["cuda" if fused else "torch"] * 3


def test_batch_span_tree(spill_scene):
    """A batch of two: per-frame preprocess and Stage 1, one ctu and one
    blend span per pass, attributes summed over the frames."""
    cams = [orbit_camera(0.3 + i, SIZE, SIZE) for i in range(2)]
    renderer = spill_renderer(fused=True)
    with use_tracer(Tracer()) as t, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, counters = renderer.render_batch_with_stats(
            spill_scene[1], stack_cameras(cams))
    (root,) = t.roots
    assert root.attrs["frames"] == 2
    assert [(c.name, c.attrs.get("frame", c.attrs.get("pass")))
            for c in root.children] == (
        [("preprocess", 0), ("stage1_compact", 0), ("preprocess", 1),
         ("stage1_compact", 1)] + [("ctu", i) for i in range(3)]
        + [("blend", i) for i in range(3)] + [("finalize", None)])
    vru = sum(s.attrs["vru_pairs"] for s in root.find("ctu"))
    assert vru == pytest.approx(float(counters["vru_pairs"].sum()),
                                rel=1e-6)
    proc = sum(s.attrs["processed_delta"] for s in root.find("blend"))
    assert proc == float(out.processed_per_pixel.sum(dtype=torch.float64))


def test_first_call_noop_and_restore(spill_scene, cam):
    """plan_first_call fires once per plan; a disabled tracer records
    nothing and leaves the render bit identical; use_tracer restores the
    previous tracer."""
    r1, r2 = spill_renderer(), spill_renderer(k_max=96, passes=2)
    before = current()
    assert isinstance(before, NoopTracer)
    with use_tracer(Tracer()) as t:
        traced = render_quiet(r1, spill_scene[1], cam[1])
        render_quiet(r1, spill_scene[1], cam[1])
        render_quiet(r2, spill_scene[1], cam[1])
    assert current() is before
    assert [root.attrs["plan_first_call"] for root in t.roots] == \
        [True, False, True]
    plain = render_quiet(r1, spill_scene[1], cam[1])
    noop = NoopTracer()
    with use_tracer(noop):
        quiet = render_quiet(r1, spill_scene[1], cam[1])
    assert noop.spans() == []
    for a, b in ((plain, quiet), (plain, traced)):
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x, y)
        for k in a[1]:
            assert torch.equal(a[1][k], b[1][k]), k
    x = torch.ones(3)
    assert Tracer().block(x) is x


def test_engine_dispatch_spans_and_metrics(spill_scene):
    """A plan-cache miss then a hit: `jit_render` carries compile True then
    False, the eager stage spans nest under both, and the engine metrics
    land in the engine's registry."""
    reg = MetricsRegistry()
    eng = RenderEngine(Renderer(grid=GridConfig(SIZE, SIZE)), device="cpu",
                       max_batch=2, telemetry=Telemetry(registry=reg))
    eng.register_scene("s", spill_scene[1])
    reqs = [RenderRequest("s", orbit_camera(a, SIZE, SIZE))
            for a in (0.3, 0.9)]
    with use_tracer(Tracer()) as t:
        eng.render_batch(reqs)
        eng.render_batch(reqs)
    batches = [r for r in t.roots if r.name == "engine.render_batch"]
    assert len(batches) == 2
    jits = [b.find("jit_render")[0] for b in batches]
    assert [j.attrs["compile"] for j in jits] == [True, False]
    for j in jits:
        (render,) = j.children
        assert render.name == "render" and render.attrs["traced"] is False
    assert batches[0].attrs["batch"] == 2 and "wall_s" in batches[0].attrs
    assert reg.counter("engine_compiles_total").value() == 1.0
    assert reg.gauge("engine_jit_cache_size").value() == 1.0
    res = f"{SIZE}x{SIZE}"
    assert reg.counter("render_batches_total", labelnames=("res",)) \
        .value(res=res) == 2.0
    assert reg.counter("render_frames_total", labelnames=("res",)) \
        .value(res=res) == 4.0


def registry_ops(reg):
    reg.counter("c_total", "a counter", ("res",)).inc(3, res="32x32")
    reg.counter("c_total", "a counter", ("res",)).inc(res="16x16")
    reg.gauge("g", "a gauge").set(-2.5)
    reg.gauge("g2", "labelled", ("scene",)).set(7, scene="train")
    h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0):
        h.observe(v)
    reg.histogram("d_seconds", "default buckets", ("tier",)).observe(
        0.02, tier="interactive")
    return reg.expose()


def test_metrics_text_equals_reference_and_guards():
    text = registry_ops(MetricsRegistry())
    assert text == registry_ops(JRegistry())
    assert 'c_total{res="32x32"} 3.0' in text
    assert 'h_seconds_bucket{le="0.1"} 1' in text
    assert 'h_seconds_bucket{le="+Inf"} 3' in text
    reg = MetricsRegistry()
    reg.counter("m", "first", ("a",))
    assert reg.counter("m", "same", ("a",)) is reg.get("m")
    with pytest.raises(ValueError):
        reg.gauge("m")                      # type mismatch
    with pytest.raises(ValueError):
        reg.counter("m", labelnames=("b",))  # label mismatch
    with pytest.raises(ValueError):
        reg.counter("n").inc(-1)            # counters only go up
    with pytest.raises(ValueError):
        reg.counter("m", labelnames=("a",)).inc(b=1)


def test_chrome_trace_and_jsonl_roundtrip(spill_scene, cam, tmp_path):
    with use_tracer(Tracer()) as t:
        render_quiet(spill_renderer(), spill_scene[1], cam[1])
    records = span_records(t)
    trace = chrome_trace(t)
    events = trace["traceEvents"]
    assert len(events) == len(records) == len(t.spans())
    assert all(e["ph"] == "X" for e in events)
    assert min(e["ts"] for e in events) == 0.0
    assert {e["name"] for e in events} >= {
        "render", "preprocess", "stage1_compact", "ctu", "blend", "finalize"}
    json.dumps(trace)
    p = tmp_path / "spans.jsonl"
    assert write_jsonl(t, p) == len(records)
    back = read_jsonl(p)
    assert [r["name"] for r in back] == [r["name"] for r in records]
    assert len(chrome_trace(back)["traceEvents"]) == len(events)
    q = tmp_path / "trace.json"
    assert write_chrome_trace(back, q) == len(events)
    assert json.loads(q.read_text())["traceEvents"] == \
        chrome_trace(back)["traceEvents"]


def test_port_imports_without_jax_or_repro():
    """The serving, obs and LOD packages (and with them the renderer, the
    PLY I/O, clustering, pruning and the kernel wrappers) import with `jax`
    and `repro` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.serving, repro_torch.obs, repro_torch.kernels.ops\n"
        "import repro_torch.lod, repro_torch.convert, repro_torch.core.io\n"
        "import repro_torch.core.clustering, repro_torch.core.pruning\n"
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
