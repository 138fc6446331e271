"""One run of one cell: set-up, the measured window, the check, the result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's scene on the card from the seed, the port's serving
engine with its plan (`repro_torch.serving`), registers the scene (the
engine's probe renders at the configuration's probe poses), and warms the
cell's own batch buckets through the scheduler; `setup_s` runs from the
start of the process to the first timed request. The port's kernels load
from its build cache inside the checkout (`build/repro_torch_kernels/`),
which the first run in a checkout fills.

With `--trace 0` one window of `--seconds`: the closed-loop clients of the
mix drive `Scheduler.submit`/`step`, and the end-to-end metrics are taken
over every request completed in it. With `--trace 1` two windows of the
mix's `profile_frames` frames each: one under `torch.profiler` (device busy
time, kernels by name, idle gaps), then one under the port's span tracer,
whose spans fence the device; the per-layer readers read both.

After the windows close, the peak memory is read, the program's state is
freed, and the reference (`portbench/reference/`) renders the compared
frames again from the same scene and poses: a sample drawn from the seed of
the window's frames and its slowest frame (`--trace 0`), or every profiled
frame (`--trace 1`, whose work it also counts for the rooflines).
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import resource
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from portbench import inputs, judge, manifest, profiling, traffic
from portbench.reference import render as reference

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_FRAMES = 6            # frames of a window compared, besides its slowest
WARM_ROUNDS = 2              # closed-loop rounds of set-up before the window


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or `names`) whose top-level name is a JAX package or
    the JAX reference package, compared whole."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


class System:
    """The system under test for one cell: the port's engine and scheduler
    holding the cell's scene, and the mix's clients."""

    def __init__(self, cell: manifest.Cell, seed: int, device):
        from repro_torch.core.camera import Camera
        from repro_torch.core.gaussians import GaussianScene
        from repro_torch.serving import workloads
        from repro_torch.serving.engine import RenderEngine
        from repro_torch.serving.scheduler import Scheduler

        cfg, mix = cell.config, cell.traffic
        self.device = torch.device(device)
        self.sync = traffic.to_device_sync(self.device)
        marks = [("import", time.perf_counter())]
        self.scene_name = cfg["name"]
        self.scene = inputs.scene_from_config(cfg, seed, self.device)
        self.sync()
        marks.append(("scene", time.perf_counter()))
        f32 = dict(dtype=torch.float32, device=self.device)
        intrinsics = {}

        def make_camera(poses: dict, i: int):
            key = (poses["fx"], poses["fy"], poses["cx"], poses["cy"])
            if key not in intrinsics:
                intrinsics[key] = [torch.tensor(v, **f32) for v in key]
            fx, fy, cx, cy = intrinsics[key]
            return Camera(R_wc=poses["R"][i], t_wc=poses["t"][i], fx=fx,
                          fy=fy, cx=cx, cy=cy, width=poses["width"],
                          height=poses["height"])

        plan = getattr(workloads, cfg["plan"])(cfg["k_max_pass"])
        self.engine = RenderEngine(plan, device=self.device,
                                   max_batch=cfg["max_batch"],
                                   incremental=bool(mix.get("session")))
        probes = inputs.config_poses(cfg, inputs.probe_thetas(cfg),
                                     self.device)
        entry = self.engine.register_scene(
            self.scene_name, GaussianScene(**self.scene),
            probe_cameras=[make_camera(probes, i)
                           for i in range(cfg["probe_poses"])])
        self.k_max = entry.k_max
        self.sync()
        marks.append(("register_scene", time.perf_counter()))
        self.marks = marks
        self.scheduler = Scheduler(self.engine)
        self.clients = traffic.clients_for(mix, cfg, seed, self.device,
                                           make_camera)

    def loop(self, **kw) -> traffic.LoopStats:
        return traffic.run_closed_loop(self.scheduler, self.scene_name,
                                       self.clients, sync=self.sync, **kw)

    def passes(self, config: dict) -> int:
        """The spill passes the engine renders the scene with now."""
        return self.engine.plan_for(self.scene_name, config["height"],
                                    config["width"]).n_passes

    def close(self):
        """Drop the program's state (engine, caches, scheduler)."""
        self.engine = self.scheduler = self.clients = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of up to k items of a stream, drawn from `rng`."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


def reference_camera(pose) -> reference.Camera:
    poses, i = pose
    return reference.Camera(R=poses["R"][i], t=poses["t"][i],
                            fx=poses["fx"], fy=poses["fy"], cx=poses["cx"],
                            cy=poses["cy"], width=poses["width"],
                            height=poses["height"])


def reference_cat(config: dict):
    """The configuration's mini-tile test for the reference (None: none)."""
    test = dict(config["test"])
    if test.pop("method") != "cat":
        return None
    return reference.Cat(**test)


def check_frames(scene: dict, frames: list, config: dict):
    """Render each (Done, image) again in the reference: (gaps per frame,
    the reference's work counts per frame, gaps per frame from plain 3DGS).
    The last, with no mini-tile test, is reported and not judged: it is the
    image the configuration's hierarchy gives up."""
    gaps, counts, plain = [], [], []
    cat = reference_cat(config)
    for done, image in frames:
        cam = reference_camera(done.pose)
        ref, c = reference.render(scene, cam, cat)
        gaps.append(judge.frame_gaps(image, ref))
        counts.append(c)
        del ref
        if cat is not None:
            ref, _ = reference.render(scene, cam, None)
            plain.append(judge.frame_gaps(image, ref))
            del ref
    return gaps, counts, plain


def _span_records(tracer) -> list[tuple]:
    """(name, parent's name or None, wall seconds) of every span."""
    out = []

    def walk(span, parent):
        out.append((span.name, parent, span.wall_s))
        for child in span.children:
            walk(child, span.name)
    for root in tracer.roots:
        walk(root, None)
    return out


def _window(system, seconds: float, seed: int):
    """The measured window: end-to-end numbers and the frames to compare."""
    sample = Reservoir(SAMPLE_FRAMES, np.random.default_rng(
        [seed & inputs.SEED_MASK, 0x5A]))
    slowest = []

    def keep(done, result):
        item = (done, result.image)
        sample.offer(item)
        if not slowest or done.latency_s > slowest[0][0].latency_s:
            slowest[:] = [item]
    stats = system.loop(seconds=seconds, on_done=keep)
    compared = list(sample.items)
    if slowest and all(slowest[0] is not x for x in compared):
        compared += slowest
    return stats, compared


def _traced_windows(system, frames: int):
    """The profiled window, then the span window: (stats of both, the
    profiled frames, the profile's reading, the span records and the span
    window's per-frame counters)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.obs import trace as obs_trace

    profiled = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_function(profiling.WINDOW):
            system.sync()
            t0 = time.perf_counter()
            stats_p = system.loop(
                frames=frames,
                on_done=lambda d, r: profiled.append((d, r.image)))
            system.sync()
            window_s = time.perf_counter() - t0
    prof_read = profiling.read(prof, window_s)
    del prof
    counters = []
    tracer = obs_trace.Tracer()
    with obs_trace.use_tracer(tracer):
        stats_s = system.loop(frames=frames,
                              on_done=lambda d, r: counters.append(
                                  r.counters))
    counters = [{k: float(v) for k, v in c.items()} for c in counters]
    return (stats_p, stats_s), profiled, prof_read, \
        _span_records(tracer), counters


def end_to_end(stats: traffic.LoopStats, setup_s: float,
               entries: list) -> dict:
    """The cell's end-to-end metrics of one window: every frame completed
    in it over its whole length, the 95th percentile of the latency of
    every request completed in it, and the set-up time."""
    lat = [d.latency_s for d in stats.done]
    values = dict(
        frames_per_s=len(stats.done) / stats.window_s,
        frame_p95_ms=1e3 * float(np.percentile(lat, 95)) if lat
        else math.nan,
        setup_s=setup_s)
    return {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
            for m in entries}


def card_line(query: str = "name,power.limit") -> str:
    """The card's `query` fields, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"nvidia-smi gave no {query}"


def host_line(before) -> str:
    """This process's processor time since `before` (a
    `resource.getrusage` reading): how busy the host kept its thread."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return (f"process cpu in the windows {now.ru_utime - before.ru_utime:.3f}"
            f" s user, {now.ru_stime - before.ru_stime:.3f} s system")


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> tuple[dict, list[str]]:
    """One run: (the result line's object, the lines printed before it)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = cell.config
    system = System(cell, seed, device)
    system.loop(frames=WARM_ROUNDS * len(system.clients))
    system.sync()
    setup_s = time.perf_counter() - t_start
    steps = [("start", t_start)] + system.marks + [("warm-up",
                                                     t_start + setup_s)]
    split = ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                      in zip(steps, steps[1:]))
    k_max, passes_warm = system.k_max, system.passes(cfg)
    retries_warm = system.engine.spill_retries
    info = [f"cell {cell.name} seed {seed} on "
            f"{card_line() if cuda else 'cpu'}",
            f"set-up {setup_s:.3f} s: k_max {k_max} probed at "
            f"{cfg['probe_poses']} poses, {passes_warm} passes of "
            f"{cfg['k_max_pass']}, spill retries {retries_warm}",
            f"set-up split: {split}"]
    usage = resource.getrusage(resource.RUSAGE_SELF)
    if not trace:
        stats, compared = _window(system, seconds, seed)
        windows = [stats]
    else:
        windows, compared, prof_read, spans, counters = _traced_windows(
            system, int(cell.traffic["profile_frames"]))
    info.append(host_line(usage))
    if cuda:
        info.append("card after the windows: " + card_line(
            "clocks.sm,clocks.mem,power.draw,temperature.gpu,"
            "clocks_throttle_reasons.active"))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    retries = system.engine.spill_retries - retries_warm
    passes = system.passes(cfg)
    scene = system.scene
    system.close()
    for w in windows:
        lat = sorted(1e3 * d.latency_s for d in w.done)
        info.append(
            f"window {w.window_s:.3f} s: {len(w.done)} frames of "
            f"{w.attempted} requests, {w.failed} failed, latency median "
            f"{statistics.median(lat) if lat else float('nan'):.3f} ms, "
            f"p95 {np.percentile(lat, 95) if lat else float('nan'):.3f} ms,"
            f" resend mean {1e3 * np.mean(w.resend_s or [0]):.3f} ms max "
            f"{1e3 * max(w.resend_s or [0]):.3f} ms")
    info.append(f"spill retries in the windows {retries}, passes now "
                f"{passes}; peak memory {peak} bytes")

    t_ref = time.perf_counter()
    gaps, counts, plain = check_frames(scene, compared, cfg)
    attempted = sum(w.attempted for w in windows)
    failed = sum(w.failed for w in windows)
    numbers = judge.combine(gaps) if gaps else dict(max_abs=math.nan,
                                                   rms=math.nan)
    ok, checks = judge.judge(numbers, cfg["limits"])
    correct = ok and failed == 0
    info.append(f"reference: {len(compared)} frames in "
                f"{time.perf_counter() - t_ref:.3f} s, per frame max_abs "
                + " ".join(f"{g['max_abs']:.6g}" for g in gaps) + ", rms "
                + " ".join(f"{g['rms']:.6g}" for g in gaps))
    if plain:
        info.append("plain 3DGS (no mini-tile test, not judged) against the "
                    "served frames: max_abs " + " ".join(
                        f"{g['max_abs']:.6g}" for g in plain) + ", rms "
                    + " ".join(f"{g['rms']:.6g}" for g in plain))

    result = dict(correct=bool(correct), attempted=attempted, failed=failed)
    if not trace:
        result["metrics"] = end_to_end(windows[0], setup_s, cell.end_to_end)
    else:
        record = types.SimpleNamespace(
            spans=spans, span_frames=len(windows[1].done),
            dispatch_s=windows[1].dispatch_s, counters=counters,
            profile=prof_read, profile_frames=len(windows[0].done),
            counts=counts)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(ROOT, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        result["metrics"] = metrics
        kernels = prof_read["kernels"]
        info.append("K1 {:.6f} s, K2 {:.6f} s of {:.6f} s busy in the "
                    "profiled window".format(*(
                        sum(t for k, t in kernels.items() if name in k)
                        for name in ("prtu_entry_kernel",
                                     "blend_fused_kernel")),
                        prof_read["busy_s"]))
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=cell.chips, memory_peak_bytes=int(peak))
    if trace:
        result["device"].update(busy_s=prof_read["busy_s"],
                                window_s=prof_read["window_s"])
        result["breakdown"] = dict(
            device_ops=profiling.top(prof_read["kernels"]),
            idle_gaps=profiling.top(prof_read["gaps"]))
    result["checks"] = checks
    return result, info


def main(argv=None, t_start: float | None = None) -> int:
    if t_start is None:
        t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = manifest.cell(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"portbench: no cell {args.workload!r}: {exc!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, info = run(cell, args.seed, args.seconds, bool(args.trace),
                       device, t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: the run loaded {leaked}: the benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for line in info:
        print(f"portbench: {line}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
