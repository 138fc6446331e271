"""The benchmark's manifest: names and units, every file found by name, a
cell added by files alone, and the result line from synthetic records.
CPU only, no card, no nvcc."""
from __future__ import annotations

import json
import shutil
import types

import pytest

from portbench import harness, manifest, traffic
from portbench.reference.render import Counts

ROOT = harness.ROOT
BENCH = manifest.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_units_and_keys(key):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[key]
    names = [e["name"] for e in BENCH[key]]
    assert len(set(names)) == len(names)
    for entry in BENCH[key]:
        assert set(entry) <= allowed, entry
        assert manifest.NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert manifest.UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200
                assert "\n" not in entry[text] and "\t" not in entry[text]
    assert all(manifest.NAME.match(n) for n in _names())


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.cell(ROOT, name)
    assert cell.config["name"] == name.split(".")[0]
    assert {"frames_per_s", "setup_s"} <= {m["name"]
                                           for m in cell.end_to_end}
    assert cell.per_layer
    for key in ("width", "height", "gaussians", "limits", "probe_poses"):
        assert key in cell.config
    assert cell.traffic["clients"] >= 1


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers_found_by_name(name):
    assert callable(manifest.reader(ROOT, name))
    assert next(m for m in BENCH["per_layer"]
                if m["name"] == name)["moves"] in {
        e["name"] for e in BENCH["end_to_end"]}


def test_new_cell_is_files_and_entries_only(tmp_path):
    """A mix and a cell added in a copy are found without editing any file
    that is already there."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*")
              if p.is_file()}
    (copy / "portbench" / "traffic" / "fresh-3c.json").write_text(
        json.dumps(dict(clients=3, azimuth="cycle", poses=16, session=False,
                        profile_frames=6)))
    bench["workloads"].append(dict(name="hd1080.fresh-3c", config="hd1080",
                                   traffic="fresh-3c", chips=1, why="x"))
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.cell(copy, "hd1080.fresh-3c")
    assert cell.traffic["clients"] == 3
    assert cell.config["width"] == 1920
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _done(i, latency):
    return traffic.Done(client=i % 2, theta=0.0, pose=None,
                        latency_s=latency, t_done=float(i))


def test_end_to_end_over_the_whole_window():
    """The rate counts every frame over the whole window; the 95th
    percentile runs over every request, not over medians of chunks."""
    lat = [0.01 * (i + 1) for i in range(100)][::-1]
    stats = traffic.LoopStats(done=[_done(i, x) for i, x in enumerate(lat)],
                              failed=0, attempted=100, window_s=25.0,
                              dispatch_s=[], resend_s=[])
    m = harness.end_to_end(stats, 12.5, BENCH["end_to_end"])
    assert m["frames_per_s"] == {"value": 4.0, "unit": "frames/s"}
    # numpy's linear rank 94.05 of the 100 sorted latencies 0.01..1.00
    assert m["frame_p95_ms"]["value"] == pytest.approx(950.5)
    assert m["setup_s"]["value"] == 12.5


def _record():
    spans = [("engine.render_batch", None, 1.0), ("render", "jit_render", 0.9),
             ("stage1_compact", "render", 0.2),
             ("stage1_compact", "render", 0.2),
             ("render_incremental", "engine.render_incremental", 0.5),
             ("stage1_incremental", "render_incremental", 0.5),
             ("stage1_incremental", "render", 0.1),
             ("ctu", "render", 0.05), ("ctu", "render", 0.05),
             ("blend", "render", 0.03)]
    counts = [Counts(gaussians=1000, pairs_smooth=600, pairs_spiky=400,
                     entries_blended=500, lanes=20000, pixels=4096)] * 2
    return types.SimpleNamespace(
        spans=spans, span_frames=4, dispatch_s=[0.5, 0.7],
        counters=[dict(tiles_reused=60.0, tiles_recompacted=40.0),
                  dict(tiles_reused=70.0, tiles_recompacted=30.0)],
        profile=dict(window_s=2.0, busy_s=1.5,
                     kernels={"void prtu_entry_kernel<1>(float*)": 1e-4,
                              "blend_fused_kernel(float*)": 2e-4,
                              "elementwise": 1.0},
                     gaps={}),
        profile_frames=2, counts=counts)


def test_readers_on_a_synthetic_record():
    from portbench import work
    r = _record()
    read = {m: manifest.reader(ROOT, m)(r) for m in METRICS}
    assert read["engine_dispatch_ms"] == pytest.approx(600.0)
    # the coherence path's outer stage1_incremental is not counted
    assert read["stage1_ms_per_frame"] == pytest.approx(1e3 * 0.5 / 4)
    assert read["ctu_ms_per_frame"] == pytest.approx(1e3 * 0.1 / 4)
    assert read["blend_ms_per_frame"] == pytest.approx(1e3 * 0.03 / 4)
    assert read["tiles_reused_pct"] == pytest.approx(65.0)
    assert read["device_idle_pct"] == pytest.approx(25.0)
    c = r.counts[0]
    assert read["k1_roofline_pct"] == pytest.approx(
        100 * 2 * work.k1_bound_s(c) / 1e-4)
    assert read["k2_roofline_pct"] == pytest.approx(
        100 * 2 * work.k2_bound_s(c) / 2e-4)
    assert read["frame_mfu_pct"] == pytest.approx(
        100 * 2 * work.frame_bound_s(c) / 2.0)


def test_readers_return_nothing_without_data():
    r = _record()
    r.counters, r.counts = [], []
    r.profile["kernels"] = {}
    for name in ("tiles_reused_pct", "k1_roofline_pct", "k2_roofline_pct",
                 "frame_mfu_pct"):
        assert manifest.reader(ROOT, name)(r) is None
