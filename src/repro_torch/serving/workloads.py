"""The Full-HD serving workload: 1920×1088 frames of a 512k-Gaussian scene,
rendered with SPILL passes of 512 entries through both CUDA kernels.

The HD scene uses compact screen footprints (many small Gaussians), so
survivor lists grow with density rather than blob size.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.camera import orbit_camera
from repro_torch.core.gaussians import random_scene
from repro_torch.core.renderer import (OverflowPolicy, RasterConfig,
                                       RenderPlan, StreamConfig, TestConfig)
from repro_torch.serving.engine import RenderEngine

HD_SCENE_KW = dict(scale_range=(-3.3, -2.7), stretch=3.0,
                   opacity_range=(-1.0, 3.0))

# Full HD, tile-aligned: 1080 rows round up to 1088 (16-px tiles).
HD1080_WIDTH, HD1080_HEIGHT = 1920, 1088
HD1080_GAUSSIANS = 1 << 19        # 512k — the paper-scale scene size
HD1080_SEED = 1080


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


def hd1080_engine(n_gaussians: int = HD1080_GAUSSIANS, *,
                  k_max_pass: int = 512, width: int = HD1080_WIDTH,
                  height: int = HD1080_HEIGHT,
                  device="cuda") -> tuple[RenderEngine, str]:
    """The 1080p serving configuration: a SPILL engine (per-pass chunk
    `k_max_pass`, pass bucket derived per scene from the probed survivor
    bound) on the CUDA CTU and fused blend kernels, with the HD scene
    registered. `width`/`height`/`n_gaussians` shrink it for tests.
    Returns (engine, scene_name)."""
    base = RenderPlan(
        test=TestConfig(backend="cuda"),
        # The pass count comes from the probed survivor bound per scene;
        # 8 passes is only the budget of a scene registered unprobed.
        stream=StreamConfig(k_max=k_max_pass, overflow=OverflowPolicy.SPILL,
                            max_spill_passes=8),
        raster=RasterConfig(fused=True))
    engine = RenderEngine(base, device=device)
    name = register_hd1080_scene(engine, n_gaussians, width=width,
                                 height=height)
    return engine, name
