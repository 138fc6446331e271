"""The port's batched render, serving engine, deadline scheduler, telemetry
and perf model, against the JAX reference at 32 px.

Batch: `render_batch_with_stats` of three poses equals the port's
per-frame `render_with_stats` bit for bit (image, alpha, work maps,
entry_alive, overflow and every counter) under CLAMP and SPILL, fused and
unfused, on the CPU where the fold runs through the plain versions of K1
and K2; each frame is held against the reference's per-frame render of
the same scene and camera (projection included) at image atol 2e-4 with
the same counter keys (less the fused blend's own), the tolerance
`test_torch_render.py` uses from the scene, at FULL_FP32 (under MIXED the reference's jitted Alg. 1 flips CAT
ties, fault F4). The 1080p engine test holds MIXED batches to single
frames bit for bit. (The reference's own vmapped batch fails on this
tree.)

Engine and scheduler: ports of the backend-free contracts of
`test_serving.py` and the non-session tests of `test_scheduler.py`, on
scenes drawn by the reference's `random_scene` and converted. The checks
are grouped into eleven tests, so that in the tier-1 run's file queue
(`-n 6 --dist loadfile`, files ordered by test count) this file sorts
after `test_stream_properties.py` and never delays it. The port is
eager and exact, so "inert" and "parity" are bit equality here.
`open_loop_trace` and `trace_fingerprint` equal the reference's for the
same seeds, and every output of the port's perf model equals the
reference's on one port frame's counters.
"""
import dataclasses
import functools
import math
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import (GridConfig as JGrid, OverflowPolicy as JPolicy,
                        Renderer as JRenderer, StreamConfig as JStream,
                        TestConfig as JTest)
from repro.core import orbit_camera as jorbit, random_scene as jrandom_scene
from repro.core import perfmodel as jpm
from repro.core.precision import FULL_FP32 as J_FP32
from repro.serving import workloads as jworkloads

from repro_torch import convert
from repro_torch.core import (FULL_FP32, GridConfig, OverflowPolicy,
                              RasterConfig,
                              RenderConfig, Renderer, StreamConfig,
                              StreamOverflowError, StreamOverflowWarning,
                              TestConfig, frame_counters, orbit_camera,
                              resize_camera, stack_cameras)
from repro_torch.core import perfmodel as tpm
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.renderer import next_pow2
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import (AdmissionRejected, MicroBatcher,
                                 RenderEngine, RenderRequest, Scheduler,
                                 Telemetry, Tier, batch_bucket,
                                 hd1080_engine, max_batch_for,
                                 open_loop_trace, register_demo_scenes,
                                 replay_open_loop, scene_bucket,
                                 trace_fingerprint)
from repro_torch.serving import workloads as tworkloads

SIZE = 32
CFG = RenderConfig(height=SIZE, width=SIZE)
DEMO_KW = dict(scale_range=(-2.9, -2.4), stretch=4.0,
               opacity_range=(-1.0, 3.0))


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


@functools.lru_cache(maxsize=None)
def ref_scene(seed: int, n: int, **kw):
    """The reference's seeded scene, and its conversion into the port."""
    scene = jrandom_scene(jax.random.PRNGKey(seed), n, **(kw or DEMO_KW))
    return scene, convert.scene_from_numpy(fields(scene))


def orbit(i, res=SIZE, n=8):
    return orbit_camera(2 * np.pi * i / n, res, res)


def fresh_engine(**kw):
    """Private telemetry per engine (the assertions read lifetime values)
    and the reference's demo scenes: 'train' 300 and 'truck' 500
    Gaussians, both in the 512 bucket."""
    kw.setdefault("telemetry", Telemetry(registry=MetricsRegistry()))
    eng = RenderEngine(CFG, device="cpu", max_batch=8, **kw)
    for seed, (name, n) in enumerate((("train", 300), ("truck", 500))):
        eng.register_scene(name, ref_scene(seed, n)[1])
    return eng


def overflowing_engine(**kw):
    eng = RenderEngine(CFG, device="cpu", max_batch=8,
                       telemetry=Telemetry(registry=MetricsRegistry()), **kw)
    eng.register_scene("s", ref_scene(8, 300)[1], k_max=4)   # overflows
    return eng


def assert_frames_equal(a_out, a_counters, b_out, b_counters):
    for name in a_out._fields:
        assert torch.equal(getattr(a_out, name), getattr(b_out, name)), name
    assert set(a_counters) == set(b_counters)
    for k in a_counters:
        assert torch.equal(a_counters[k], b_counters[k]), k


# ---------------------------------------------------------------------------
# render_batch_with_stats
# ---------------------------------------------------------------------------

# Capacities that cover the scene's longest list (256): a clamped entry
# could differ between the packages at a 1-ulp depth tie.
POLICIES = {"clamp": dict(k_max=256),
            "spill": dict(k_max=64, overflow="spill", max_spill_passes=4)}


# Counters only the fused blend reports.
FUSED_ONLY = {"kblocks_processed", "kblocks_total"}


@functools.lru_cache(maxsize=None)
def reference_render(policy):
    """The reference's jitted per-frame render (its plain jnp path, which
    the fused blend matches within 2e-4)."""
    stream = dict(POLICIES[policy])
    if "overflow" in stream:
        stream["overflow"] = JPolicy(stream["overflow"])
    ref = JRenderer(grid=JGrid(SIZE, SIZE), test=JTest(precision=J_FP32),
                    stream=JStream(**stream))
    return jax.jit(ref.render_with_stats)


def check_batch_equals_per_frame_and_reference(policy, fused):
    jscene, scene = ref_scene(3, 700, scale_range=(-2.5, -2.0), stretch=4.0,
                              opacity_range=(-2.0, 3.5))
    jcams = [jorbit(0.7 * i + 0.2, SIZE, SIZE) for i in range(3)]
    cams = [convert.camera_from_numpy(fields(c)) for c in jcams]
    renderer = Renderer(
        grid=GridConfig(SIZE, SIZE),
        test=TestConfig(backend="cuda" if fused else "torch",
                        precision=FULL_FP32),
        stream=StreamConfig(**POLICIES[policy]),
        raster=RasterConfig(fused=fused))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", StreamOverflowWarning)
        out, counters = renderer.render_batch_with_stats(
            scene, stack_cameras(cams))
        singles = [renderer.render_with_stats(scene, c) for c in cams]
    assert out.image.shape == (3, SIZE, SIZE, 3)
    assert all(v.shape == (3,) for v in counters.values())
    assert not out.overflow.any()
    if policy == "spill":
        assert float(counters["spill_passes"].max()) > 1
    for i, (s_out, s_counters) in enumerate(singles):
        assert_frames_equal(
            type(out)(*(x[i] for x in out)), frame_counters(counters, i),
            s_out, s_counters)
        want, wc = reference_render(policy)(jscene, jcams[i])
        np.testing.assert_allclose(s_out.image.numpy(),
                                   np.asarray(want.image), rtol=0, atol=2e-4)
        assert set(s_counters) - FUSED_ONLY == set(wc)
    with pytest.raises(ValueError, match="resolution"):
        renderer.render_batch_with_stats(
            scene, stack_cameras([orbit(0, res=2 * SIZE)]))


def check_stack_cameras_and_legacy_shim():
    """stack_cameras validates the static fields and round-trips; the
    deprecated module-level batch entry point warns and equals the plan."""
    with pytest.raises(ValueError):
        stack_cameras([orbit(0, res=32), orbit(1, res=64)])
    with pytest.raises(ValueError):
        stack_cameras([])
    cams = [orbit(i) for i in range(2)]
    batched = stack_cameras(cams)
    assert batched.frames == 2
    for i, c in enumerate(cams):
        for f in ("R_wc", "t_wc", "fx", "fy", "cx", "cy"):
            assert torch.equal(getattr(batched.frame(i), f), getattr(c, f))
    scene = ref_scene(0, 300)[1]
    with pytest.warns(DeprecationWarning):
        out, counters = tpipeline.render_batch_with_stats(scene, batched,
                                                          CFG)
    want, wc = CFG.to_plan().render_batch_with_stats(scene, batched)
    assert_frames_equal(out, counters, want, wc)


# ---------------------------------------------------------------------------
# engine: buckets, padding, plan cache
# ---------------------------------------------------------------------------

def check_buckets():
    assert [scene_bucket(n) for n in (0, 1, 2, 3, 300, 512)] == \
        [1, 1, 2, 4, 512, 512]
    assert batch_bucket(3, max_batch=8) == 4
    assert batch_bucket(5, max_batch=8) == 8
    assert batch_bucket(0, max_batch=8) == batch_bucket(1, max_batch=8) == 1
    assert batch_bucket(1, max_batch=1) == 1
    # a non-pow2 cap is itself the top bucket; never exceeded
    assert [batch_bucket(n, max_batch=6) for n in (3, 5, 6)] == [4, 6, 6]
    for cap in (1, 3, 6, 8):
        buckets = [batch_bucket(n, max_batch=cap) for n in range(1, cap + 1)]
        assert buckets == sorted(buckets) and all(b <= cap for b in buckets)
    assert max_batch_for(1088, 1920) == 2
    assert max_batch_for(32, 32) == 64
    assert max_batch_for(4096, 4096) == 1


def check_batch_padding_inert_and_real_gaussian_count():
    """A 3-request batch renders at bucket 4 (one padding frame) and each
    frame equals the same request served alone (bucket 1); counters report
    the real Gaussian count, not the 512 bucket."""
    eng = fresh_engine()
    reqs = [RenderRequest("truck", orbit(i)) for i in range(3)]
    batched = eng.render_batch(reqs)
    assert [r.bucket_size for r in batched] == [4, 4, 4]
    assert [r.batch_size for r in batched] == [3, 3, 3]
    for req, r in zip(reqs, batched):
        single, = eng.render_batch([req])
        assert single.bucket_size == 1 and single.batch_size == 1
        assert torch.equal(r.image, single.image)
        assert torch.equal(r.alpha, single.alpha)
        for k in r.counters:
            assert torch.equal(r.counters[k], single.counters[k]), k
        assert float(r.counters["n_gaussians"]) == 500.0


def check_scene_bucket_padding_inert():
    """pad_scenes=True (300 -> 512 Gaussians) changes no image or counter
    against the exact-size scene at the same k_max."""
    scene = ref_scene(2, 300)[1]
    frames = []
    for pad in (True, False):
        eng = RenderEngine(CFG, device="cpu", max_batch=8, pad_scenes=pad,
                           telemetry=Telemetry(registry=MetricsRegistry()))
        eng.register_scene("s", scene, k_max=300)
        frames.append(eng.render_batch(
            [RenderRequest("s", orbit(i)) for i in range(2)]))
    for x, y in zip(*frames):
        assert torch.equal(x.image, y.image)
        for k in x.counters:
            if k != "cat_mask_bytes":         # sized by the scene bucket
                assert torch.equal(x.counters[k], y.counters[k]), k


def check_plan_cache_hits_misses_and_lru():
    """Keyed by (scene bucket, plan, batch bucket): other cameras and batch
    sizes inside a bucket, and another scene in the same bucket, hit; a new
    bucket misses; past jit_cache_size the oldest entry is evicted."""
    eng = fresh_engine()
    eng.render_batch([RenderRequest("train", orbit(i)) for i in range(3)])
    assert eng.compile_count == 1
    eng.render_batch([RenderRequest("train", orbit(i)) for i in (7, 5, 3, 1)])
    eng.render_batch([RenderRequest("truck", orbit(i)) for i in range(4)])
    assert eng.compile_count == 1
    eng.render_batch([RenderRequest("train", orbit(0))])
    assert eng.compile_count == 2
    eng.render_batch([RenderRequest("truck", orbit(1))])
    assert eng.compile_count == 2
    reg = eng.telemetry.registry
    assert reg.get("engine_compiles_total").value() == 2
    assert reg.get("engine_jit_cache_size").value() == 2

    small = fresh_engine(jit_cache_size=1)
    for reqs in ([RenderRequest("train", orbit(0))],
                 [RenderRequest("train", orbit(i)) for i in range(2)],
                 [RenderRequest("train", orbit(2))]):
        small.render_batch(reqs)
    assert small.compile_count == 3 and small.jit_cache_evictions == 2
    assert small.telemetry.registry.get(
        "engine_jit_cache_evictions_total").value() == 2
    with pytest.raises(ValueError):
        fresh_engine(jit_cache_size=0)


def check_probe_registration_and_scene_lru():
    """Probe-measured k_max is a power of two below the scene bucket and
    covers the probes; max_scenes evicts the least recently served scene."""
    eng = fresh_engine(max_scenes=2)
    probes = [orbit(i) for i in range(4)]
    entry = eng.register_scene("probed", ref_scene(5, 300)[1],
                               probe_cameras=probes)
    assert entry.k_max == next_pow2(entry.k_max) < entry.n_bucket == 512
    assert eng.scene_names() == ["truck", "probed"]      # train evicted
    assert eng.scene_evictions == 1
    for r in eng.render_batch([RenderRequest("probed", c) for c in probes]):
        assert not r.overflow
    eng.render_batch([RenderRequest("truck", orbit(0))])  # LRU touch
    eng.register_scene("train", ref_scene(0, 300)[1])
    assert eng.scene_names() == ["truck", "train"]
    with pytest.raises(KeyError):
        eng.render_batch([RenderRequest("probed", orbit(0))])
    assert eng.telemetry.registry.get(
        "engine_scene_evictions_total").value() == 2


# ---------------------------------------------------------------------------
# engine: overflow policy, SPILL, fused override
# ---------------------------------------------------------------------------

def check_overflow_policy_defaults_and_explicit():
    """CLAMP is upgraded to WARN by default; an explicit plan policy and an
    explicit override are kept."""
    strict = Renderer(stream=StreamConfig(overflow=OverflowPolicy.RAISE))
    kw = dict(device="cpu")
    assert RenderEngine(strict, **kw).plan.stream.overflow \
        is OverflowPolicy.RAISE
    assert RenderEngine(CFG, **kw).plan.stream.overflow is OverflowPolicy.WARN
    assert RenderEngine(CFG, overflow="clamp", **kw).plan.stream.overflow \
        is OverflowPolicy.CLAMP


def check_serving_overflow_policy(policy):
    eng = overflowing_engine(**({} if policy == "warn"
                                else {"overflow": policy}))
    reqs = [RenderRequest("s", orbit(i)) for i in range(2)]
    if policy == "warn":
        with pytest.warns(StreamOverflowWarning, match="k_max=4"):
            results = eng.render_batch(reqs)
        assert eng.telemetry.snapshot()["overflow_frames"] == 2
        assert "OVERFLOW" in eng.telemetry.format_snapshot()
    elif policy == "raise":
        with pytest.raises(StreamOverflowError):
            eng.render_batch(reqs)
        results = []
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error", StreamOverflowWarning)
            results = eng.render_batch(reqs)
    assert all(r.overflow for r in results)
    # telemetry recorded the frames before the policy fired
    assert eng.telemetry.total_overflow_frames == 2


def check_serving_spill_never_overflows_and_matches_clamp_free():
    """SPILL on a guaranteed-overflow registration (k_max=4): no frame
    reports overflow, the capacity is learned by retries, and the images
    equal an overflow-proof engine's."""
    eng = overflowing_engine(overflow=OverflowPolicy.SPILL)
    reqs = [RenderRequest("s", orbit(i)) for i in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("error", StreamOverflowWarning)
        results = eng.render_batch(reqs)
    assert all(not r.overflow for r in results)
    assert all(float(r.counters["spill_passes"]) >= 2.0 for r in results)
    assert eng.spill_retries >= 1
    assert results[0].passes_run > eng.plan_for("s", SIZE, SIZE).n_passes
    snap = eng.telemetry.snapshot()
    assert snap["spill_passes"] >= 2.0 and snap["overflow_frames"] == 0
    assert snap["total_spill_retries"] == eng.spill_retries
    assert "spill" in eng.telemetry.format_snapshot()
    ref = RenderEngine(CFG, device="cpu", max_batch=8,
                       telemetry=Telemetry(registry=MetricsRegistry()))
    ref.register_scene("s", ref_scene(8, 300)[1], k_max=512)
    for spill_r, ref_r in zip(results, ref.render_batch(reqs)):
        assert torch.equal(spill_r.image, ref_r.image)


def check_fused_engine_matches_and_caches_separately():
    plain, fused = fresh_engine(), fresh_engine(fused=True)
    assert fused.plan.raster.fused and not plain.plan.raster.fused
    reqs = [RenderRequest("train", orbit(i)) for i in range(2)]
    for x, y in zip(plain.render_batch(reqs), fused.render_batch(reqs)):
        np.testing.assert_allclose(x.image.numpy(), y.image.numpy(),
                                   rtol=0, atol=2e-4)
        assert float(y.counters["swept_per_pixel"]) <= \
            float(x.counters["swept_per_pixel"])
        assert "kblocks_processed" in y.counters
    n = fused.compile_count
    fused.render_batch(reqs)
    assert fused.compile_count == n


def check_engine_rejects_bad_batches():
    eng = fresh_engine()
    with pytest.raises(ValueError, match="mixed scenes"):
        eng.render_batch([RenderRequest("train", orbit(0)),
                          RenderRequest("truck", orbit(1))])
    with pytest.raises(ValueError, match="mixed resolutions"):
        eng.render_batch([RenderRequest("train", orbit(0, res=32)),
                          RenderRequest("train", orbit(1, res=64))])
    with pytest.raises(ValueError, match="max_batch"):
        eng.render_batch([RenderRequest("train", orbit(i))
                          for i in range(9)])
    assert eng.render_batch([]) == []


def check_entry_kernel_index_bound():
    """K1 indexes entries, conic rows and mask bytes in int32: one launch
    is held to T·K·16 < 2**31 (a batch of two 1080p frames, 2 x 8160
    tiles x 512 entries, needs 133.7M), and a fold of B·T rows past it is
    launched in row ranges (`entry_row_ranges`) instead of refused."""
    from repro_torch.kernels import prtu
    prtu.check_entry_index(2 * 8160, 512)
    with pytest.raises(ValueError, match="int32"):
        prtu.check_entry_index((1 << 31) // (16 * 512), 512)
    assert prtu.entry_row_ranges(2 * 8160, 512) == [(0, 2 * 8160)]
    assert len(prtu.entry_row_ranges((1 << 31) // (16 * 512), 512)) == 2


def check_hd1080_engine_batches_two_frames():
    """The 1080p configuration shrunk to 64² / 2k Gaussians batches like
    the full one would at its own size; max_batch_for(1088, 1920) is 2."""
    engine, name = hd1080_engine(2048, width=64, height=64, k_max_pass=128,
                                 device="cpu")
    assert engine.max_batch == max_batch_for(64, 64)
    cams = tworkloads.hd1080_cameras(2, width=64, height=64)
    reqs = [RenderRequest(name, c) for c in cams]
    pair = engine.render_batch(reqs)
    for req, r in zip(reqs, pair):
        single, = engine.render_batch([req])
        assert r.bucket_size == 2 and single.bucket_size == 1
        assert torch.equal(r.image, single.image)
        assert r.passes_run == single.passes_run


# ---------------------------------------------------------------------------
# MicroBatcher and telemetry
# ---------------------------------------------------------------------------

def check_microbatcher_mixed_workload():
    eng = fresh_engine()
    mb = MicroBatcher(eng, max_batch=4)
    futs = [mb.submit("train" if i % 2 == 0 else "truck", orbit(i))
            for i in range(6)]
    assert mb.pending == 6 and mb.flush() == 6 and mb.pending == 0
    for i, f in enumerate(futs):
        r = f.result(timeout=0)
        assert r.frame.request.scene == ("train" if i % 2 == 0 else "truck")
        assert r.frame.batch_size == 3
        assert r.image.shape == (SIZE, SIZE, 3)
        assert 0.0 <= r.queue_s <= r.total_s and r.render_s > 0.0


def check_microbatcher_unknown_scene_fails_future():
    mb = MicroBatcher(fresh_engine())
    fut = mb.submit("nope", orbit(0))
    mb.flush()
    with pytest.raises(KeyError):
        fut.result(timeout=0)


def check_microbatcher_bit_compatible_with_direct_batches():
    eng = fresh_engine()
    mb = MicroBatcher(eng, max_batch=8)
    cams = [orbit(i) for i in range(5)]
    scenes = ["train", "truck", "train", "truck", "train"]
    futs = [mb.submit(s, c) for s, c in zip(scenes, cams)]
    assert mb.flush() == 5
    direct = fresh_engine()
    train = direct.render_batch(
        [RenderRequest("train", cams[i]) for i in (0, 2, 4)])
    truck = direct.render_batch(
        [RenderRequest("truck", cams[i]) for i in (1, 3)])
    for fut, ref in zip(futs, [train[0], truck[0], train[1], truck[1],
                               train[2]]):
        r = fut.result()
        assert r.frame.batch_size == ref.batch_size
        assert torch.equal(r.image, ref.image)
        assert r.tier is Tier.BATCH
        assert not r.degraded and not r.deadline_missed
    chunked = MicroBatcher(fresh_engine(), max_batch=2)
    futs = [chunked.submit("train", orbit(i)) for i in range(5)]
    chunked.flush()
    assert [f.result().frame.batch_size for f in futs] == [2, 2, 2, 2, 1]
    assert chunked.scheduler.chunk_for(1088, 1920) == 2   # no pixel budget


def check_telemetry_percentiles_and_one_host_copy():
    eng = fresh_engine()
    mb = MicroBatcher(eng)
    for i in range(5):
        mb.submit("train", orbit(i))
        mb.submit("truck", orbit(i))
    mb.flush()
    s = eng.telemetry.snapshot()
    assert s["frames"] == 10 and s["batches"] == 2
    assert 0.0 < s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    assert s["fps"] > 0.0 and s["modeled_fps"] > 0.0
    assert s["counters"]["processed_per_pixel"] >= 0.0
    assert "fps" in eng.telemetry.format_snapshot()
    from repro_torch.serving.telemetry import host_counters
    got = host_counters({"a": torch.tensor([1.0, 2.0]), "b": [3.0, 4.0]})
    assert {k: v.tolist() for k, v in got.items()} == \
        {"a": [1.0, 2.0], "b": [3.0, 4.0]}


def check_telemetry_snapshot_counter_union_and_tiers():
    """Counters first appearing mid-window survive `snapshot()`; per-tier
    request windows feed their percentiles; rejections count without a
    latency sample."""
    tel = Telemetry(window=8, registry=MetricsRegistry())
    tel.record_batch(batch_size=1, bucket_size=1, latency_s=0.01,
                     counters=dict(processed_per_pixel=[2.0]),
                     height=SIZE, width=SIZE)
    tel.record_batch(batch_size=1, bucket_size=1, latency_s=0.01,
                     counters=dict(processed_per_pixel=[4.0],
                                   spill_passes=[3.0]),
                     height=SIZE, width=SIZE)
    snap = tel.snapshot()
    assert snap["counters"]["processed_per_pixel"] == pytest.approx(3.0)
    assert snap["counters"]["spill_passes"] == pytest.approx(1.5)
    assert snap["spill_passes"] == pytest.approx(1.5)
    t = Telemetry(registry=MetricsRegistry())
    for ms in (10, 20, 30, 40):
        t.record_request(tier="interactive", queue_s=0.001,
                         total_s=ms / 1e3)
    t.record_request(tier="batch", queue_s=0.0, total_s=0.5,
                     deadline_missed=True)
    t.record_rejection("interactive")
    tiers = t.tier_snapshot()
    assert tiers["interactive"]["count"] == 4
    assert tiers["interactive"]["p50_ms"] == pytest.approx(25.0, abs=5.0)
    assert tiers["batch"]["count"] == 1
    assert (t.total_requests, t.total_deadline_misses, t.total_rejected) \
        == (5, 1, 1)
    assert t.snapshot()["tiers"]["interactive"]["count"] == 4


def check_perfmodel_matches_reference_on_port_counters():
    """Every output of the port's perf model equals the reference's, on the
    counters of one port frame."""
    eng = fresh_engine(fused=True)
    r, = eng.render_batch([RenderRequest("train", orbit(1))])
    c = {k: float(v) for k, v in r.counters.items()}
    tw = tpm.Workload.from_counters(c, height=SIZE, width=SIZE)
    jw = jpm.Workload.from_counters(c, height=SIZE, width=SIZE)
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
    pairs = [(tpm.FLICKER_HW, jpm.FLICKER_HW),
             (tpm.FLICKER_NO_CTU, jpm.FLICKER_NO_CTU),
             (tpm.GSCORE_HW, jpm.GSCORE_HW),
             (tpm.BASELINE_64VRU, jpm.BASELINE_64VRU)]
    for th, jh in pairs:
        assert dataclasses.asdict(th) == dataclasses.asdict(jh)
        assert tpm.frame_time_s(tw, th) == jpm.frame_time_s(jw, jh)
        assert tpm.render_time_s(tw, th) == jpm.render_time_s(jw, jh)
        assert tpm.ctu_stall_rate(tw, th) == jpm.ctu_stall_rate(jw, jh)
        assert tpm.energy_j(tw, th) == jpm.energy_j(jw, jh)
        assert tpm.render_energy_j(tw, th) == jpm.render_energy_j(jw, jh)
        assert tpm.area_mm2(th) == jpm.area_mm2(jh)
    assert tpm.gpu_frame(tw, tpm.XNX_GPU) == jpm.gpu_frame(jw, jpm.XNX_GPU)
    assert tpm.cat_stage_bytes(c) == jpm.cat_stage_bytes(c)
    assert tpm.effective_imbalance(1.8, 16) == \
        jpm.effective_imbalance(1.8, 16)
    assert eng.telemetry.snapshot()["modeled_fps"] == \
        jpm.frame_time_s(jw, jpm.FLICKER_HW)["fps"]


# ---------------------------------------------------------------------------
# scheduler: dispatch order, deadlines, admission
# ---------------------------------------------------------------------------

def check_edf_order_within_tier():
    sched = Scheduler(fresh_engine(), max_batch=1)
    futs = {name: sched.submit("train", orbit(i), deadline_s=d,
                               tier=Tier.INTERACTIVE)
            for i, (name, d) in enumerate((("a", 50.0), ("b", 10.0),
                                           ("c", 30.0)))}
    order = []
    for _ in range(3):
        sched.step()
        order += [n for n, f in futs.items() if f.done() and n not in order]
    assert order == ["b", "c", "a"]
    assert all(not f.result().deadline_missed for f in futs.values())


def check_interactive_preempts_batch_and_groups_by_key():
    sched = Scheduler(fresh_engine(), max_batch=1)
    fb = sched.submit("train", orbit(0))                  # BATCH default
    fi = sched.submit("train", orbit(1), deadline_s=60.0,
                      tier=Tier.INTERACTIVE)
    sched.step()
    assert fi.done() and not fb.done()
    sched.step()
    assert fi.result().tier is Tier.INTERACTIVE
    assert fb.result().tier is Tier.BATCH
    assert not fb.result().deadline_missed

    sched = Scheduler(fresh_engine())
    fi = sched.submit("train", orbit(0), deadline_s=60.0,
                      tier=Tier.INTERACTIVE)
    fb1, fb2 = sched.submit("train", orbit(1)), sched.submit("train",
                                                             orbit(2))
    other = sched.submit("truck", orbit(3))
    assert sched.step() == 3
    assert fi.done() and fb1.done() and fb2.done() and not other.done()
    assert fi.result().frame.batch_size == 3
    sched.step()
    assert other.result().frame.batch_size == 1

    sched = Scheduler(fresh_engine())          # FIFO for deadline-free
    futs = [sched.submit("train", orbit(0)), sched.submit("truck", orbit(1)),
            sched.submit("train", orbit(2))]
    assert sched.pending == 3 and sched.flush() == 3 and sched.pending == 0
    assert [f.result().frame.batch_size for f in futs] == [2, 1, 2]


def check_deadline_miss_accounting():
    eng = fresh_engine()
    sched = Scheduler(eng, max_batch=1)
    # deadline 0: a cold predictor admits it, and any render misses it
    fut = sched.submit("train", orbit(0), deadline_s=0.0,
                       tier=Tier.INTERACTIVE)
    sched.flush()
    r = fut.result()
    assert r.deadline_missed and not r.degraded
    t = eng.telemetry
    assert t.total_requests == 1 and t.total_deadline_misses == 1
    assert t.registry.get("serve_deadline_misses_total").value(
        tier="interactive") == 1
    assert t.registry.get("serve_requests_total").value(
        tier="interactive") == 1


def check_degrade_parity_with_direct_lowres_render():
    eng = fresh_engine()
    sched = Scheduler(eng)
    sched.register_fallback(32, 32, 16, 16)
    sched.predictor.seed(("train", 32, 32), 100.0)
    sched.predictor.seed(("train", 16, 16), 0.0)
    cam = orbit(3)
    fut = sched.submit("train", cam, deadline_s=5.0, tier=Tier.INTERACTIVE)
    assert sched.degraded == 1
    sched.flush()
    r = fut.result()
    assert r.degraded and not r.deadline_missed
    assert r.image.shape == (16, 16, 3)
    ref, = eng.render_batch(
        [RenderRequest("train", resize_camera(cam, width=16, height=16))])
    assert torch.equal(r.image, ref.image)
    assert eng.telemetry.total_degraded == 1
    assert eng.telemetry.registry.get("serve_degraded_total").value() == 1


def check_admission_rejection_under_injected_overload():
    eng = fresh_engine()
    sched = Scheduler(eng)
    sched.register_fallback(32, 32, 16, 16)
    sched.predictor.seed(("train", 32, 32), 100.0)
    sched.predictor.seed(("train", 16, 16), 100.0)
    fut = sched.submit("train", orbit(0), deadline_s=1.0,
                       tier=Tier.INTERACTIVE)
    assert fut.done() and sched.pending == 0
    with pytest.raises(AdmissionRejected):
        fut.result()
    assert sched.rejected == 1 and sched.degraded == 0
    assert eng.telemetry.total_rejected == 1
    assert eng.telemetry.registry.get("serve_rejected_total").value() == 1
    ok = sched.submit("train", orbit(1))        # deadline-free: admitted
    sched.flush()
    assert not ok.result().degraded


def check_predicted_wait_fallbacks_and_pixel_budget():
    sched = Scheduler(fresh_engine(), max_batch=2)
    assert sched.predicted_wait_s(("train", 32, 32)) == 0.0   # unknown key
    sched.predictor.seed(("train", 32, 32), 1.0)
    for i in range(3):
        sched.submit("train", orbit(i), deadline_s=50.0,
                     tier=Tier.INTERACTIVE)
    # 3 queued -> 2 chunks of <= 2 ahead, plus the request's own batch
    for tier in (Tier.INTERACTIVE, Tier.BATCH):
        assert sched.predicted_wait_s(("train", 32, 32), tier,
                                      float("inf")) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        sched.register_fallback(32, 32, 32, 32)
    sched.register_fallback(32, 32, 16, 16)
    sched.register_fallback(16, 16, 8, 8)
    with pytest.raises(ValueError):
        sched.register_fallback(8, 8, 32, 32)       # would cycle
    assert (8, 8) not in sched._fallbacks
    budget = Scheduler(fresh_engine(), pixel_budget=32 * 32 * 4)
    assert budget.chunk_for(32, 32) == 4
    assert budget.chunk_for(16, 16) == 8             # engine max_batch
    assert budget.chunk_for(1088, 1920) == 1
    with pytest.raises(ValueError):
        Scheduler(fresh_engine(), max_batch=9)


# ---------------------------------------------------------------------------
# open-loop traffic
# ---------------------------------------------------------------------------

TRACE_KW = [
    dict(seed=3, scenes=("train", "truck"), n_sessions=2,
         interactive_deadline_s=1.0),
    dict(seed=0, scenes=("hd1080",), resolutions=((1088, 1920),),
         interactive_frac=0.75, interactive_deadline_s=0.4),
]


def check_open_loop_trace_equals_reference(kw):
    a = open_loop_trace(50, **kw)
    want = jworkloads.open_loop_trace(50, **kw)
    assert [dataclasses.astuple(x) for x in a] == \
        [dataclasses.astuple(x) for x in want]
    assert trace_fingerprint(a) == jworkloads.trace_fingerprint(want)
    assert a == open_loop_trace(50, **kw)
    assert trace_fingerprint(a) != trace_fingerprint(
        open_loop_trace(50, **{**kw, "seed": kw["seed"] + 1}))
    ts = [ev.t for ev in a]
    assert ts[0] == 0.0 and all(x < y for x, y in zip(ts, ts[1:]))
    c = open_loop_trace(50, **{**kw, "interactive_deadline_s": 99.0})
    assert trace_fingerprint(a) == trace_fingerprint(c)
    assert {ev.tier for ev in a} == {"interactive", "batch"}
    # the replayed poses are the reference's
    for ev in a[:3]:
        jcam = jorbit(jworkloads._arrival_theta(ev), ev.width, ev.height)
        cam = tworkloads.arrival_camera(ev)
        np.testing.assert_array_equal(cam.R_wc.numpy(),
                                      np.asarray(jcam.R_wc))


def check_replay_open_loop_serves_every_arrival():
    eng = fresh_engine()
    register_demo_scenes(eng, 0, sizes={"train": 300})   # the port's scene
    sched = Scheduler(eng)
    trace = open_loop_trace(12, seed=1, scenes=("train",),
                            interactive_deadline_s=60.0)
    out = replay_open_loop(sched, trace, rate_rps=500.0)
    assert [a for a, _ in out] == trace
    results = [f.result() for _, f in out]
    assert len(results) == 12 and sched.pending == 0
    assert not any(r.deadline_missed for r in results)
    assert eng.telemetry.total_requests == 12
    assert math.isfinite(eng.telemetry.snapshot()["p99_ms"])


# ---------------------------------------------------------------------------
# the tests: one per group of checks
# ---------------------------------------------------------------------------

def test_batch_equals_per_frame_and_reference():
    for policy in ("clamp", "spill"):
        for fused in (False, True):
            check_batch_equals_per_frame_and_reference(policy, fused)


def test_stack_cameras_and_legacy_shim():
    check_stack_cameras_and_legacy_shim()


def test_buckets():
    check_buckets()


def test_engine_padding_is_inert():
    check_batch_padding_inert_and_real_gaussian_count()
    check_scene_bucket_padding_inert()


def test_engine_plan_cache_and_scene_registry():
    check_plan_cache_hits_misses_and_lru()
    check_probe_registration_and_scene_lru()


def test_engine_overflow_policies():
    check_overflow_policy_defaults_and_explicit()
    for policy in ("warn", "raise", "clamp"):
        check_serving_overflow_policy(policy)
    check_serving_spill_never_overflows_and_matches_clamp_free()


def test_engine_variants_and_bad_batches():
    check_fused_engine_matches_and_caches_separately()
    check_engine_rejects_bad_batches()
    check_entry_kernel_index_bound()
    check_hd1080_engine_batches_two_frames()


def test_microbatcher():
    check_microbatcher_mixed_workload()
    check_microbatcher_unknown_scene_fails_future()
    check_microbatcher_bit_compatible_with_direct_batches()


def test_telemetry_and_perfmodel():
    check_telemetry_percentiles_and_one_host_copy()
    check_telemetry_snapshot_counter_union_and_tiers()
    check_perfmodel_matches_reference_on_port_counters()


def test_scheduler_dispatch_and_admission():
    check_edf_order_within_tier()
    check_interactive_preempts_batch_and_groups_by_key()
    check_deadline_miss_accounting()
    check_degrade_parity_with_direct_lowres_render()
    check_admission_rejection_under_injected_overload()
    check_predicted_wait_fallbacks_and_pixel_budget()


def test_open_loop_traffic():
    for kw in TRACE_KW:
        check_open_loop_trace_equals_reference(kw)
    check_replay_open_loop_serves_every_arrival()
