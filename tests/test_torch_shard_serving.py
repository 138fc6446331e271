"""The port's serving engine over a mesh (`RenderEngine(mesh=...,
shard_tiles=...)`, `serving/sharding.py`) on the CPU.

Meshes of repeated CPU devices stand in for cards. Every frame of a
tile-sharded, frame-sharded or frame x tile (2 x 2, odd batch of 3 padded
to 4) engine equals the unsharded engine's frame bit for bit (image,
alpha and every counter the unsharded frame has), with the occupancy
counters added; so do sessions of the incremental mode and LOD batches.
The reference's own `test_engine_frame_by_tile_composition` fails on
this tree, so frame x tile is held against the port's unsharded engine,
not the reference's. The engine's mesh checks raise the reference's
messages, `tile_mesh` without enough devices names `devices=`, and the
shard gauges' Prometheus lines equal the reference's for the same batch.
A subprocess imports the new modules with `jax` and `repro` blocked.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import RenderConfig as JRenderConfig
from repro.obs import MetricsRegistry as JRegistry
from repro.obs.export import prometheus_text as jprometheus_text
from repro.serving import RenderEngine as JEngine
from repro.serving import Telemetry as JTelemetry
from repro.serving import sharding as jshd

from repro_torch.core import (GridConfig, OverflowPolicy, RasterConfig,
                              RenderConfig, Renderer, StreamConfig,
                              TestConfig, orbit_camera)
from repro_torch.lod import LODConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.export import prometheus_text
from repro_torch.serving import (RenderEngine, RenderRequest, Telemetry,
                                 register_demo_scenes)
from repro_torch.serving import sharding as shd

SIZE = 32
CFG = RenderConfig(height=SIZE, width=SIZE)
SHARD_KEYS = ("tile_shards", "shard_entries_max", "shard_entries_min")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(tiles: int, frames: int = 1):
    return shd.tile_mesh(tiles, frame_shards=frames,
                         devices=[CPU] * (tiles * frames))


def orbit(i, res=SIZE):
    return orbit_camera(2 * np.pi * i / 8, res, res)


def spill_base():
    """The serving plan's shape at 32²: SPILL passes through the kernels'
    plain versions."""
    return Renderer(grid=GridConfig(SIZE, SIZE),
                    test=TestConfig(backend="cuda"),
                    stream=StreamConfig(k_max=32,
                                        overflow=OverflowPolicy.SPILL,
                                        max_spill_passes=2),
                    raster=RasterConfig(fused=True))


def engine(base=CFG, **kw):
    eng = RenderEngine(base, device="cpu", max_batch=8,
                       telemetry=Telemetry(registry=MetricsRegistry()), **kw)
    register_demo_scenes(eng, 300, sizes={"s": 300})
    return eng


def serve(eng, reqs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return eng.render_batch(reqs)


def assert_frames_match(got, want, tile_shards=None):
    """Each result of `got` equals `want`'s on image, alpha and every
    counter `want` has; a tile-sharded engine adds the occupancy ones."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.image, w.image) and torch.equal(g.alpha, w.alpha)
        bad = [k for k in w.counters
               if not torch.equal(g.counters[k], w.counters[k])]
        assert not bad, bad
        extra = set(SHARD_KEYS) if tile_shards else set()
        assert set(g.counters) == set(w.counters) | extra
        if tile_shards:
            assert float(g.counters["tile_shards"]) == tile_shards
            assert g.counters["shard_entries_max"] >= \
                g.counters["shard_entries_min"]
        assert g.overflow == w.overflow


def test_engine_mesh_rules():
    """shard_tiles puts a ShardConfig into the plan and keeps the given
    mesh; a mesh whose model axis has another size is rejected with the
    reference's message; without a mesh, `tile_mesh` over the visible CUDA
    devices raises when there are too few, naming devices=; a mesh alone
    leaves the plan unsharded."""
    eng = RenderEngine(CFG, device="cpu", shard_tiles=2, mesh=cpu_mesh(2))
    assert eng.mesh.shape == {"data": 1, "model": 2}
    assert eng.plan.shard.tile_shards == 2
    with pytest.raises(ValueError) as want:
        JEngine(JRenderConfig(height=SIZE, width=SIZE), shard_tiles=4,
                mesh=jshd.tile_mesh(2))
    with pytest.raises(ValueError) as got:
        RenderEngine(CFG, device="cpu", shard_tiles=4, mesh=cpu_mesh(2))
    assert str(got.value) == str(want.value)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="devices="):
            RenderEngine(CFG, device="cpu", shard_tiles=2)
    framed = RenderEngine(CFG, device="cpu", mesh=cpu_mesh(1, frames=2))
    assert framed.plan.shard.tile_shards == 1
    assert framed.plan == RenderEngine(CFG, device="cpu").plan


@pytest.mark.parametrize("tiles", [2, 4])
def test_engine_tile_sharded_matches_unsharded(tiles):
    """Tile-sharded engines (CLAMP through the torch backends, SPILL
    through the kernels' plain versions) serve a batch of 3 and a single
    request equal to the unsharded engine, the plan cache keyed on the
    sharded plan."""
    reqs = [RenderRequest("s", orbit(i), request_id=i) for i in range(3)]
    for base in (CFG, spill_base()):
        ref = engine(base)
        eng = engine(base, shard_tiles=tiles, mesh=cpu_mesh(tiles))
        for batch in (reqs, reqs[:1]):
            assert_frames_match(serve(eng, batch), serve(ref, batch), tiles)
        assert eng.compile_count == ref.compile_count
        assert eng.spill_retries == ref.spill_retries
        assert all(key[1].shard.tile_shards == tiles for key in eng._cache)


def test_engine_frame_by_tile_composition():
    """2 frame shards x 2 tile shards on one mesh of four CPU devices, odd
    batch of 3 (bucket 4, split 2 + 2 over the data rows): every frame
    equals the unsharded engine's bit for bit; frame sharding alone too."""
    reqs = [RenderRequest("s", orbit(i), request_id=i) for i in range(3)]
    for base in (CFG, spill_base()):
        want = serve(engine(base), reqs)
        got = serve(engine(base, shard_tiles=2, mesh=cpu_mesh(2, frames=2)),
                    reqs)
        assert_frames_match(got, want, tile_shards=2)
        assert (got[0].batch_size, got[0].bucket_size) == (3, 4)
        assert_frames_match(serve(engine(base, mesh=cpu_mesh(1, frames=2)),
                                  reqs), want)
        # An odd bucket over two data rows pads one frame, then slices it.
        assert_frames_match(serve(engine(base, mesh=cpu_mesh(1, frames=2)),
                                  reqs[:1]), want[:1])


def test_engine_sessions_and_lod_sharded():
    """A sharded incremental engine's session (a cold frame and a reuse
    frame) and a sharded LOD engine's batch equal the unsharded engines'
    frames bit for bit."""
    sess = [RenderRequest("s", dataclasses.replace(
        orbit(0), t_wc=orbit(0).t_wc + torch.tensor([d, 0.0, 0.0])),
        session="a") for d in (0.0, 1e-4)]
    plain = engine(spill_base(), incremental=True)
    sharded = engine(spill_base(), incremental=True, shard_tiles=2,
                     mesh=cpu_mesh(2))
    for r in sess:
        assert_frames_match(serve(sharded, [r]), serve(plain, [r]),
                            tile_shards=2)
    assert float(serve(sharded, sess[1:])[0].counters["tiles_reused"]) > 0

    cfg = LODConfig(num_clusters=16, probe_k_max=64, probe_passes=2,
                    min_bucket=64)
    probes = [orbit(i) for i in range(2)]
    lods = []
    for kw in ({}, dict(shard_tiles=4, mesh=cpu_mesh(4))):
        eng = RenderEngine(spill_base(), device="cpu", max_batch=8,
                           telemetry=Telemetry(registry=MetricsRegistry()),
                           **kw)
        gen = torch.Generator().manual_seed(3)
        from repro_torch.core import random_scene
        eng.register_scene("l", random_scene(gen, 400), lod=cfg,
                           probe_cameras=probes)
        lods.append(serve(eng, [RenderRequest("l", c) for c in probes]))
    assert_frames_match(lods[1], lods[0], tile_shards=4)
    assert "lod_selection_ratio" in lods[1][0].counters


def test_shard_gauges():
    """The engine's telemetry publishes `render_tile_shards` and the two
    occupancy gauges from a sharded batch's counters (batch means), and
    none from an unsharded one; their Prometheus lines equal the
    reference's for the same batch."""
    eng = engine(shard_tiles=4, mesh=cpu_mesh(4))
    got = serve(eng, [RenderRequest("s", orbit(i)) for i in range(2)])
    reg = eng.telemetry.registry
    assert reg.gauge("render_tile_shards").value() == 4.0
    for key in ("shard_entries_max", "shard_entries_min"):
        mean = float(np.mean([float(r.counters[key]) for r in got]))
        assert reg.gauge("render_" + key).value() == pytest.approx(mean)
    plain = engine()
    serve(plain, [RenderRequest("s", orbit(0))])
    assert "render_tile_shards" not in prometheus_text(
        plain.telemetry.registry)

    counters = {"tile_shards": np.full(2, 4.0, np.float32),
                "shard_entries_max": np.array([610.0, 598.0], np.float32),
                "shard_entries_min": np.array([230.0, 251.0], np.float32),
                "processed_per_pixel": np.array([3.0, 4.0], np.float32)}
    texts = []
    for tel, fmt in ((Telemetry(registry=MetricsRegistry()),
                      prometheus_text),
                     (JTelemetry(registry=JRegistry()), jprometheus_text)):
        tel.record_batch(batch_size=2, bucket_size=2, latency_s=0.01,
                         counters=counters, height=SIZE, width=SIZE)
        texts.append([line for line in fmt(tel.registry).splitlines()
                      if "render_tile_shards" in line
                      or "render_shard_entries" in line])
    assert len(texts[0]) == 9
    assert texts[0] == texts[1]


def test_sharding_modules_import_without_jax():
    """repro_torch.distributed and serving.sharding (and the engine) import
    with `jax` and `repro` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch.distributed, repro_torch.distributed.fault\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.serving.sharding\n"
        "import repro_torch.serving.engine\n"
        "from repro_torch import ShardConfig\n"
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
