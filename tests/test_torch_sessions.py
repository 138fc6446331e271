"""The port's sticky incremental sessions: `RenderEngine(incremental=True)`,
`RenderRequest.session`, `Scheduler.submit(session=)`,
`MicroBatcher.submit(session=)` and the telemetry's coherence totals,
against the session contracts of `test_serving.py` and
`test_scheduler.py`, at 32 px on the reference's seeded scene converted.

Each served session frame is held against the port's own library
`render_incremental` bit for bit, and against the reference engine's
session path per frame (the coherence counters exactly, images within
2e-4: the reference's programs are jitted, fault F4). The reference's
vmapped batch fails on this tree, so no comparison goes through it.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import orbit_camera as jorbit, random_scene as jrandom_scene
from repro.core.pipeline import RenderConfig as JRenderConfig
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving import MicroBatcher as JMicroBatcher
from repro.serving import RenderEngine as JRenderEngine
from repro.serving.telemetry import Telemetry as JTelemetry

from repro_torch import convert
from repro_torch.core import RenderConfig, orbit_camera, render_incremental
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import (MicroBatcher, RenderEngine, RenderRequest,
                                 Scheduler, Telemetry, Tier, open_loop_trace,
                                 replay_open_loop)

SIZE = 32
CFG = RenderConfig(height=SIZE, width=SIZE)
# Compact footprints and a tiny orbit step: the regime where per-tile
# candidate sets are stable frame to frame, so sticky sessions really
# reuse survivor streams (asserted below: the tests must not pass through
# the full-recompaction fallback alone).
COHERENT_KW = dict(scale_range=(-3.3, -2.7), stretch=3.0,
                   opacity_range=(-1.0, 3.0))
COHERENT_STEP = 0.001
COHERENCE_KEYS = ("tiles_reused", "tiles_recompacted", "full_recompactions")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@functools.lru_cache(maxsize=None)
def ref_scene(seed: int, n: int):
    scene = jrandom_scene(jax.random.PRNGKey(seed), n, **COHERENT_KW)
    return scene, convert.scene_from_numpy(fields(scene))


def coherent_engine(**kw):
    """Private telemetry per engine (the assertions read lifetime values)
    and scene 's' of 300 Gaussians at k_max 512."""
    kw.setdefault("telemetry", Telemetry(registry=MetricsRegistry()))
    kw.setdefault("incremental", True)
    eng = RenderEngine(CFG, device="cpu", max_batch=8, **kw)
    eng.register_scene("s", ref_scene(11, 300)[1], k_max=512)
    return eng


def smooth(i, res=SIZE):
    return orbit_camera(i * COHERENT_STEP, res, res)


def counts(r) -> dict:
    return {k: int(r.counters[k]) for k in COHERENCE_KEYS}


# ---------------------------------------------------------------------------
# sticky sessions through the batcher, against the library and the reference
# ---------------------------------------------------------------------------

def test_sticky_sessions_through_microbatcher():
    """A session's cache survives across flush ticks: later frames of a
    smooth trajectory reuse tiles, only frame 0 is a full recompaction,
    every frame equals the library's cold-cache render bit for bit (image,
    alpha, every counter outside the coherence keys) and its warm-cache
    render with the coherence keys too, and the reference engine's session
    path frame by frame (coherence counters exactly, image within 2e-4)."""
    eng = coherent_engine()
    plan = eng.plan_for("s", SIZE, SIZE)
    tiles = plan.grid.make().num_tiles
    mb = MicroBatcher(eng)
    jeng = JRenderEngine(JRenderConfig(height=SIZE, width=SIZE),
                         max_batch=8, incremental=True,
                         telemetry=JTelemetry(registry=JMetricsRegistry()))
    jeng.register_scene("s", ref_scene(11, 300)[0], k_max=512)
    jmb = JMicroBatcher(jeng)
    lib_cache = None
    n_frames = 5
    for i in range(n_frames):              # one flush per frame = sticky
        fut = mb.submit("s", smooth(i), session="cli-1")
        assert mb.flush() == 1
        r = fut.result(timeout=0)
        assert r.frame.batch_size == r.frame.bucket_size == 1
        assert r.frame.request.session == "cli-1"
        cold, cold_c, _ = render_incremental(plan, eng.scene("s"), smooth(i),
                                             None, enforce=False)
        warm, warm_c, lib_cache = render_incremental(
            plan, eng.scene("s"), smooth(i), lib_cache, enforce=False)
        assert torch.equal(r.image, cold.image)
        assert torch.equal(r.frame.alpha, cold.alpha)
        assert torch.equal(r.image, warm.image)
        for k, v in warm_c.items():
            want = (torch.tensor(300.0) if k == "n_gaussians" else v)
            assert torch.equal(r.counters[k], want), k
            if k not in COHERENCE_KEYS and k != "n_gaussians":
                assert torch.equal(v, cold_c[k]), k
        jfut = jmb.submit("s", jorbit(i * COHERENT_STEP, SIZE, SIZE),
                          session="cli-1")
        assert jmb.flush() == 1
        jr = jfut.result(timeout=0)
        assert counts(r) == counts(jr)
        np.testing.assert_allclose(r.image.numpy(), np.asarray(jr.image),
                                   rtol=0, atol=2e-4)
        assert set(r.counters) == set(jr.counters)
        if i == 0:
            assert counts(r)["full_recompactions"] == 1
        else:
            assert counts(r)["full_recompactions"] == 0
            assert counts(r)["tiles_reused"] > 0
        assert counts(r)["tiles_reused"] \
            + counts(r)["tiles_recompacted"] == tiles
    t = eng.telemetry
    assert t.total_full_recompactions == 1
    assert t.total_tiles_reused + t.total_tiles_recompacted \
        == n_frames * tiles
    assert t.total_tiles_reused > 0
    assert (t.total_tiles_reused, t.total_tiles_recompacted) == (
        jeng.telemetry.total_tiles_reused,
        jeng.telemetry.total_tiles_recompacted)


def test_mixed_coherent_incoherent_batch_window():
    """Sessioned and sessionless requests share one flush window: results
    come back in submission order, the sessionless pair batches (bucket
    2), the sessioned frames render incrementally (bucket 1), two sessions
    keep two caches, and each incremental frame equals its batched twin
    bit for bit (same plan, same camera, the other path)."""
    eng = coherent_engine()
    mb = MicroBatcher(eng)
    futs = [mb.submit("s", smooth(0)),                     # plain
            mb.submit("s", smooth(0), session="a"),
            mb.submit("s", smooth(1)),                     # plain
            mb.submit("s", smooth(1), session="b")]
    assert mb.flush() == 4
    rs = [f.result(timeout=0) for f in futs]
    assert [r.frame.bucket_size for r in rs] == [2, 1, 2, 1]
    assert [r.frame.request.session for r in rs] == [None, "a", None, "b"]
    assert all(float(rs[i].counters["full_recompactions"]) == 1.0
               for i in (1, 3))
    assert len(eng._frame_caches) == 2
    for plain, coh in ((0, 1), (2, 3)):
        assert torch.equal(rs[plain].image, rs[coh].image)
        assert torch.equal(rs[plain].frame.alpha, rs[coh].frame.alpha)
        for k, v in rs[plain].counters.items():
            assert torch.equal(v, rs[coh].counters[k]), k


# ---------------------------------------------------------------------------
# telemetry attribution
# ---------------------------------------------------------------------------

def test_incremental_telemetry_attribution():
    """The lifetime coherence totals and the registry counters both equal
    the sum of the per-frame counters; frames record as batches of one
    with the real Gaussian count; the engine.render_incremental span
    carries the frame's decision."""
    eng = coherent_engine()
    sums = dict(tiles_reused=0, tiles_recompacted=0, full_recompactions=0)
    tracer = obs_trace.Tracer()
    with obs_trace.use_tracer(tracer):
        for i in range(4):
            r, = eng.render_batch(
                [RenderRequest("s", smooth(i), session="cli")])
            assert float(r.counters["n_gaussians"]) == 300.0
            assert r.passes_run == 1 and r.render_s > 0
            for k in sums:
                sums[k] += int(r.counters[k])
    t = eng.telemetry
    assert t.total_tiles_reused == sums["tiles_reused"]
    assert t.total_tiles_recompacted == sums["tiles_recompacted"]
    assert t.total_full_recompactions == sums["full_recompactions"]
    reg = t.registry
    for k, v in sums.items():
        assert reg.get(f"render_{k}_total").value() == v, k
    snap = t.snapshot()
    assert snap["total_tiles_reused"] == sums["tiles_reused"]
    assert snap["frames"] == 4 and snap["batches"] == 4
    assert [s.name for s in tracer.roots] == ["engine.render_incremental"] * 4
    assert [s.attrs["full_recompaction"] for s in tracer.roots] == \
        [True, False, False, False]
    assert sum(s.attrs["tiles_reused"] for s in tracer.roots) == \
        sums["tiles_reused"]
    assert tracer.roots[0].attrs["session"] == "cli"
    assert [c.name for c in tracer.roots[0].children] == \
        ["render_incremental"]


def test_incremental_fallback_frames_not_double_counted():
    """A jump-cut frame is charged once: one full_recompactions increment,
    its tiles all in tiles_recompacted, and the lifetime totals sum to
    exactly frames x tiles."""
    eng = coherent_engine()
    tiles = eng.plan_for("s", SIZE, SIZE).grid.make().num_tiles
    # frame 2 jumps out to theta=2.0, frame 3 jumps back to the smooth path
    cams = [smooth(0), smooth(1), orbit_camera(2.0, SIZE, SIZE), smooth(2)]
    for cam in cams:
        eng.render_batch([RenderRequest("s", cam, session="cli")])
    t = eng.telemetry
    assert t.total_full_recompactions == 3      # cold + 2 jumps
    assert t.total_tiles_reused + t.total_tiles_recompacted \
        == len(cams) * tiles
    assert t.total_tiles_recompacted >= 3 * tiles


def test_sessionless_traffic_isolated():
    """Sessionless traffic through an incremental engine takes the batched
    path untouched (no cache entries, no coherence counters), and a
    sessioned request on an engine without `incremental` is batched like
    any other."""
    eng = coherent_engine()
    rs = eng.render_batch([RenderRequest("s", smooth(0)),
                           RenderRequest("s", smooth(1))])
    assert not eng._frame_caches
    assert eng.telemetry.total_tiles_reused == 0
    assert eng.telemetry.total_full_recompactions == 0
    assert not set(COHERENCE_KEYS) & set(rs[0].counters)
    plain = coherent_engine(incremental=False)
    r, = plain.render_batch([RenderRequest("s", smooth(0), session="x")])
    assert not plain._frame_caches
    assert "tiles_reused" not in r.counters
    assert torch.equal(r.image, rs[0].image)
    with pytest.raises(ValueError, match="max_sessions"):
        coherent_engine(max_sessions=0)


# ---------------------------------------------------------------------------
# the session-cache LRU and scene eviction
# ---------------------------------------------------------------------------

def test_session_caches_bounded_by_max_sessions():
    """The LRU cap holds at every step and evictions are mirrored to the
    registry counter."""
    eng = coherent_engine(max_sessions=2)
    for i in range(6):
        eng.render_batch(
            [RenderRequest("s", smooth(i), session=f"s{i}")])
        assert len(eng._frame_caches) <= 2
    assert set(eng._frame_caches) == {"s4", "s5"}     # LRU survivors
    assert eng.session_evictions == 4
    assert eng.telemetry.registry.get(
        "engine_session_evictions_total").value() == 4


def test_session_lru_refreshes_on_use():
    """Serving a session again moves it to the MRU end: eviction hits the
    least recently served session, not insertion order."""
    eng = coherent_engine(max_sessions=2)
    eng.render_batch([RenderRequest("s", smooth(0), session="a")])
    eng.render_batch([RenderRequest("s", smooth(0), session="b")])
    eng.render_batch([RenderRequest("s", smooth(1), session="a")])  # touch a
    eng.render_batch([RenderRequest("s", smooth(0), session="c")])
    assert set(eng._frame_caches) == {"a", "c"}       # b was LRU
    assert eng.session_evictions == 1


def test_evicted_session_pays_one_full_recompaction():
    """An evicted session's next frame behaves exactly like a cold cache:
    one full recompaction, then it is coherent again."""
    eng = coherent_engine(max_sessions=1)
    r0, = eng.render_batch([RenderRequest("s", smooth(0), session="a")])
    assert int(r0.counters["full_recompactions"]) == 1
    eng.render_batch([RenderRequest("s", smooth(0), session="b")])  # evicts a
    r2, = eng.render_batch([RenderRequest("s", smooth(1), session="a")])
    assert int(r2.counters["full_recompactions"]) == 1
    r3, = eng.render_batch([RenderRequest("s", smooth(2), session="a")])
    assert int(r3.counters["full_recompactions"]) == 0
    assert int(r3.counters["tiles_reused"]) > 0


def test_scene_eviction_drops_its_sessions():
    """When the scene registry LRU evicts a scene, the frame caches of its
    sessions go with it."""
    eng = coherent_engine(max_scenes=2, max_sessions=8)
    eng.register_scene("s2", ref_scene(12, 200)[1], k_max=512)
    eng.render_batch([RenderRequest("s", smooth(0), session="a")])
    eng.render_batch([RenderRequest("s2", smooth(0), session="b")])
    assert set(eng._frame_caches) == {"a", "b"}
    # registering a third scene evicts the LRU scene ("s") and session "a"
    eng.register_scene("s3", ref_scene(13, 200)[1], k_max=512)
    assert set(eng._frame_caches) == {"b"}
    assert eng.session_evictions == 1
    assert eng._session_scene == {"b": "s2"}
    assert eng.telemetry.registry.get(
        "engine_session_evictions_total").value() == 1


# ---------------------------------------------------------------------------
# exact coherence totals; the scheduler and the open-loop replay
# ---------------------------------------------------------------------------

def test_registry_coherence_counters_match_exact_totals():
    """Across mixed batch sizes (a cold and a warm session in one window)
    the registry counters equal the exact lifetime totals equal the sum of
    the per-frame integer counters."""
    eng = coherent_engine(max_sessions=8)
    sums = dict(tiles_reused=0, tiles_recompacted=0, full_recompactions=0)
    batches = [
        [RenderRequest("s", smooth(0), session="a")],
        [RenderRequest("s", smooth(0), session="b"),
         RenderRequest("s", smooth(1), session="a")],
        [RenderRequest("s", smooth(1), session="b"),
         RenderRequest("s", smooth(2), session="a"),
         RenderRequest("s", smooth(0), session="c")],
    ]
    for reqs in batches:
        for r in eng.render_batch(reqs):
            for k in sums:
                sums[k] += int(r.counters[k])
    assert sums["full_recompactions"] == 3 and sums["tiles_reused"] > 0
    t = eng.telemetry
    assert t.total_tiles_reused == sums["tiles_reused"]
    assert t.total_tiles_recompacted == sums["tiles_recompacted"]
    assert t.total_full_recompactions == sums["full_recompactions"]
    for k, v in sums.items():
        assert t.registry.get(f"render_{k}_total").value() == v, k


def test_scheduler_and_replay_carry_sessions():
    """`Scheduler.submit(session=)` reaches the engine: a deadline-tier
    session is served incrementally beside a sessionless request of the
    same dispatch; `replay_open_loop` submits each arrival's session, so
    the engine holds one cache per session of the trace and served every
    sessioned arrival through it."""
    eng = coherent_engine(max_sessions=8)
    sched = Scheduler(eng)
    f1 = sched.submit("s", smooth(0), tier=Tier.INTERACTIVE, session="v")
    f2 = sched.submit("s", smooth(1), tier=Tier.INTERACTIVE)
    f3 = sched.submit("s", smooth(1), tier=Tier.INTERACTIVE, session="v")
    sched.flush()
    r1, r2, r3 = (f.result(timeout=0) for f in (f1, f2, f3))
    assert r1.frame.request.session == r3.frame.request.session == "v"
    assert r2.frame.request.session is None
    assert int(r1.counters["full_recompactions"]) == 1
    assert int(r3.counters["full_recompactions"]) == 0
    assert torch.equal(r2.image, r3.image)

    eng = coherent_engine(max_sessions=8)
    trace = open_loop_trace(12, seed=3, scenes=("s",), n_sessions=2,
                            resolutions=((SIZE, SIZE),))
    sessions = {a.session for a in trace} - {None}
    assert sessions
    out = replay_open_loop(Scheduler(eng), trace, rate_rps=1e6)
    served = [(a, fut.result(timeout=0)) for a, fut in out]
    assert [r.frame.request.session for _, r in served] == \
        [a.session for a in trace]
    assert set(eng._frame_caches) == sessions
    n_sessioned = sum(a.session is not None for a in trace)
    t = eng.telemetry
    assert t.total_tiles_reused + t.total_tiles_recompacted == \
        n_sessioned * eng.plan_for("s", SIZE, SIZE).grid.make().num_tiles
