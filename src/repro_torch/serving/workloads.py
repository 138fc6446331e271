"""Shared serving workloads: the two-scene demo registry, the Full-HD
(1920×1088 / 512k-Gaussian) workload rendered with SPILL passes of 512
entries through both CUDA kernels, its frame-size-aware batching policy,
and the replayable open-loop traffic generator of the deadline scheduler.

Scenes are drawn by the port's seeded `random_scene` (a torch generator),
so they are not the reference's scenes of the same seed; traces come from
numpy's generator, so the same seed gives the reference's trace exactly.
The HD scene uses compact screen footprints (many small Gaussians), so
survivor lists grow with density rather than blob size.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.camera import orbit_camera
from repro_torch.core.gaussians import random_scene
from repro_torch.core.renderer import (OverflowPolicy, RasterConfig,
                                       RenderPlan, StreamConfig, TestConfig)
from repro_torch.serving.engine import RenderEngine

DEMO_SCENE_KW = dict(scale_range=(-2.9, -2.4), stretch=4.0,
                     opacity_range=(-1.0, 3.0))

HD_SCENE_KW = dict(scale_range=(-3.3, -2.7), stretch=3.0,
                   opacity_range=(-1.0, 3.0))

# Full HD, tile-aligned: 1080 rows round up to 1088 (16-px tiles).
HD1080_WIDTH, HD1080_HEIGHT = 1920, 1088
HD1080_GAUSSIANS = 1 << 19        # 512k — the paper-scale scene size
HD1080_SEED = 1080


def register_demo_scenes(engine: RenderEngine, n_gaussians: int, *,
                         sizes: Optional[dict] = None,
                         k_max: Optional[int] = None,
                         probe_cameras=None) -> list[str]:
    """Register the standard mixed workload: 'train' at `n_gaussians`,
    'truck' at 3/4 of it (override both via `sizes={name: n}`), scene i
    drawn with seed i. Returns the registered scene names.

    probe_cameras: forwarded to `RenderEngine.register_scene` — when given
    (and k_max is None) each scene's k_max is measured over them."""
    if sizes is None:
        sizes = {"train": n_gaussians,
                 "truck": max(n_gaussians * 3 // 4, 16)}
    for seed, (name, n) in enumerate(sizes.items()):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        engine.register_scene(
            name, random_scene(gen, n, **DEMO_SCENE_KW),
            k_max=k_max, probe_cameras=probe_cameras)
    return list(sizes)


def max_batch_for(height: int, width: int,
                  pixel_budget: int = 1 << 22) -> int:
    """Batching policy for large frames: the biggest power-of-two batch
    whose total pixel count stays within `pixel_budget` (default 4M px —
    two Full-HD frames), at most 64. A 1920×1088 frame lands at 2 and
    anything larger serves frame-at-a-time."""
    frames = max(1, pixel_budget // (height * width))
    return min(1 << (frames.bit_length() - 1), 64)


def trajectory_cameras(n_frames: int, *, width: int = 128, height: int = 128,
                       step: float = 2 * math.pi / 64,
                       jump_frames=(), jump_offset: float = 2.0,
                       start: float = 0.0, radius: float = 4.0,
                       center=(0.0, 0.0, 4.0), fov_deg: float = 60.0) -> list:
    """A client-like camera trajectory: a smooth orbit (azimuth advances by
    `step` per frame) with jump-cuts injected at `jump_frames` — at each
    such frame the azimuth additionally skips ahead by `jump_offset`
    radians. Deterministic."""
    jumps = set(jump_frames)
    cams, theta = [], start
    for i in range(n_frames):
        if i in jumps and i > 0:
            theta += jump_offset
        cams.append(orbit_camera(theta, width, height, radius=radius,
                                 center=center, fov_deg=fov_deg))
        theta += step
    return cams


# ---------------------------------------------------------------------------
# Open-loop traffic for the deadline scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request of an open-loop trace.

    `t` is the arrival time at **unit rate** (mean inter-arrival 1.0);
    `replay_open_loop` divides by the offered rate, so one trace replays
    at any load without changing its request sequence."""
    t: float
    scene: str
    width: int
    height: int
    tier: str                      # "interactive" | "batch"
    deadline_s: Optional[float]    # latency budget (None = no deadline)
    session: Optional[str]


def open_loop_trace(n_requests: int, *, seed: int = 0,
                    scenes: Sequence[str] = ("train", "truck"),
                    resolutions: Sequence[tuple[int, int]] = ((32, 32),),
                    interactive_frac: float = 0.75,
                    interactive_deadline_s: Optional[float] = None,
                    batch_deadline_s: Optional[float] = None,
                    n_sessions: int = 0,
                    theta_step: float = 2 * math.pi / 64) -> list[Arrival]:
    """A deterministic seeded open-loop arrival process: Poisson arrivals
    (exponential inter-arrival times at unit rate) over a mixed
    scene x resolution x tier x session request population.

    Same seed -> the same trace (`np.random.default_rng` streams are
    versioned), equal to the reference's. Sessioned requests (when
    `n_sessions` > 0) walk a smooth per-session orbit, so an incremental
    engine sees coherent streams; sessionless ones get an independent
    random pose each.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0, size=n_requests)
    t = np.cumsum(gaps) - gaps[0]          # first arrival at t=0
    session_theta = {f"s{i}": 0.0 for i in range(n_sessions)}
    trace = []
    for i in range(n_requests):
        scene = scenes[int(rng.integers(len(scenes)))]
        height, width = resolutions[int(rng.integers(len(resolutions)))]
        interactive = bool(rng.random() < interactive_frac)
        session = None
        if n_sessions and interactive and rng.random() < 0.5:
            session = f"s{int(rng.integers(n_sessions))}"
            theta = session_theta[session]
            session_theta[session] = theta + theta_step
        else:
            theta = float(rng.uniform(0.0, 2 * math.pi))
        trace.append(Arrival(
            t=float(t[i]), scene=scene, width=width, height=height,
            tier="interactive" if interactive else "batch",
            deadline_s=(interactive_deadline_s if interactive
                        else batch_deadline_s),
            session=session))
    return trace


def trace_fingerprint(trace: Sequence[Arrival]) -> str:
    """Hex digest of the trace's categorical sequence (scene, resolution,
    tier, session per arrival) — rate- and deadline-independent."""
    h = hashlib.sha256()
    for a in trace:
        h.update(f"{a.scene}|{a.width}x{a.height}|{a.tier}|"
                 f"{a.session}\n".encode())
    return h.hexdigest()[:16]


def arrival_camera(a: Arrival, device="cpu"):
    """The camera `replay_open_loop` submits for an arrival."""
    return orbit_camera(_arrival_theta(a), a.width, a.height, device=device)


def replay_open_loop(scheduler, trace: Sequence[Arrival], *,
                     rate_rps: float) -> list[tuple[Arrival, object]]:
    """Replay a trace open-loop at `rate_rps` requests/sec: arrivals are
    submitted at their scheduled wall-clock times **regardless of
    completions** (a slow server builds a queue instead of slowing the
    clients), with `scheduler.step()` dispatching continuously between
    arrivals, then the pending set is drained. Returns [(arrival, future)]
    in arrival order; rejected arrivals carry a future whose exception is
    `AdmissionRejected`.

    Cameras are built on the engine's device for the whole trace before
    the clock starts, so client-side work is not billed to the server."""
    from repro_torch.serving.scheduler import Tier
    tiers = {"interactive": Tier.INTERACTIVE, "batch": Tier.BATCH}
    device = scheduler.engine.device
    cameras = [arrival_camera(a, device) for a in trace]
    out = []
    t0 = time.perf_counter()
    for a, camera in zip(trace, cameras):
        due = t0 + a.t / rate_rps
        while True:
            now = time.perf_counter()
            if now >= due:
                break
            if scheduler.pending:
                scheduler.step()       # dispatch while the clock runs
            else:
                time.sleep(min(due - now, 5e-4))
        out.append((a, scheduler.submit(
            a.scene, camera, deadline_s=a.deadline_s, tier=tiers[a.tier],
            session=a.session)))
    scheduler.flush()
    return out


def _arrival_theta(a: Arrival) -> float:
    """Deterministic pose angle for an arrival (hash of its identity), the
    reference's, so two replays of one trace submit identical cameras."""
    h = hashlib.sha256(
        f"{a.t}|{a.scene}|{a.session}".encode()).digest()
    return int.from_bytes(h[:4], "big") / 2**32 * 2 * math.pi


def hd1080_cameras(n: int, *, width: int = HD1080_WIDTH,
                   height: int = HD1080_HEIGHT) -> list:
    """n orbit poses, evenly spaced around the scene."""
    return [orbit_camera(2 * math.pi * i / max(n, 1), width, height)
            for i in range(n)]


def register_hd1080_scene(engine: RenderEngine,
                          n_gaussians: int = HD1080_GAUSSIANS, *,
                          name: str = "hd1080", n_probes: int = 2,
                          width: int = HD1080_WIDTH,
                          height: int = HD1080_HEIGHT) -> str:
    """Register the HD workload scene (seeded), with k_max measured from
    `n_probes` orbit probes at the serving resolution. Returns its name."""
    gen = torch.Generator(device="cpu").manual_seed(HD1080_SEED)
    scene = random_scene(gen, n_gaussians, **HD_SCENE_KW)
    engine.register_scene(
        name, scene,
        probe_cameras=hd1080_cameras(n_probes, width=width, height=height))
    return name


def hd1080_plan(k_max_pass: int = 512) -> RenderPlan:
    """The 1080p serving plan: SPILL passes of `k_max_pass` entries on the
    CUDA CTU (K1) and the fused blend (K2)."""
    return RenderPlan(
        test=TestConfig(backend="cuda"),
        # The pass count comes from the probed survivor bound per scene;
        # 8 passes is only the budget of a scene registered unprobed.
        stream=StreamConfig(k_max=k_max_pass, overflow=OverflowPolicy.SPILL,
                            max_spill_passes=8),
        raster=RasterConfig(fused=True))


def hd1080_engine(n_gaussians: int = HD1080_GAUSSIANS, *,
                  k_max_pass: int = 512, width: int = HD1080_WIDTH,
                  height: int = HD1080_HEIGHT, device="cuda",
                  telemetry=None) -> tuple[RenderEngine, str]:
    """The 1080p serving configuration: a SPILL engine (per-pass chunk
    `k_max_pass`, pass bucket derived per scene from the probed survivor
    bound) on the CUDA CTU and fused blend kernels, batching at
    `max_batch_for(height, width)` frames (2 at 1920×1088), with the HD
    scene registered. `width`/`height`/`n_gaussians` shrink it for tests.
    Returns (engine, scene_name)."""
    engine = RenderEngine(hd1080_plan(k_max_pass), device=device,
                          telemetry=telemetry,
                          max_batch=max_batch_for(height, width))
    name = register_hd1080_scene(engine, n_gaussians, width=width,
                                 height=height)
    return engine, name
