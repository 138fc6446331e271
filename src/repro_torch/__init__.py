"""FLICKER's contribution-aware 3DGS render path in PyTorch, with
hand-written Hopper kernels for the CTU and the fused blend.

Layout mirrors the JAX reference package module for module:
    core/      scene, camera, projection, Stage-1 compaction, CAT, blend,
               the staged RenderPlan
    kernels/   CUDA kernels (csrc/), their wrappers and plain versions
    serving/   RenderEngine and the 1080p workload
    convert    numpy -> port types, for parity tests
"""
from repro_torch.core import (GaussianScene, GridConfig, OverflowPolicy,
                              RasterConfig, RenderPlan, Renderer,
                              StreamConfig, TestConfig, orbit_camera,
                              random_scene)
from repro_torch.serving import RenderEngine, RenderRequest, hd1080_engine

__all__ = [
    "GaussianScene", "GridConfig", "OverflowPolicy", "RasterConfig",
    "RenderPlan", "Renderer", "StreamConfig", "TestConfig", "orbit_camera",
    "random_scene", "RenderEngine", "RenderRequest", "hd1080_engine",
]
