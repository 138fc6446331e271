"""FLICKER's contribution-aware 3DGS render path in PyTorch, with
hand-written Hopper kernels for every TPU kernel of the reference: the
entry-stream and dense CTU (Mini-Tile CAT) and the fused and full-sweep
blends.

Layout mirrors the JAX reference package module for module:
    core/      scene, camera, projection, Stage-1 compaction, CAT, blend,
               the staged RenderPlan (stream and dense dataflows, the AABB
               and OBB baselines), the legacy RenderConfig shim
    kernels/   CUDA kernels (csrc/), their wrappers and plain versions
    serving/   RenderEngine and the 1080p workload
    convert    numpy -> port types, for parity tests
"""
from repro_torch.core import (FLICKER_CONFIG, GSCORE_CONFIG, VANILLA_CONFIG,
                              GaussianScene, GridConfig, OverflowPolicy,
                              RasterConfig, RenderConfig, RenderPlan,
                              Renderer, StreamConfig, TestConfig,
                              orbit_camera, random_scene)
from repro_torch.serving import RenderEngine, RenderRequest, hd1080_engine

__all__ = [
    "FLICKER_CONFIG", "GSCORE_CONFIG", "VANILLA_CONFIG", "RenderConfig",
    "GaussianScene", "GridConfig", "OverflowPolicy", "RasterConfig",
    "RenderPlan", "Renderer", "StreamConfig", "TestConfig", "orbit_camera",
    "random_scene", "RenderEngine", "RenderRequest", "hd1080_engine",
]
