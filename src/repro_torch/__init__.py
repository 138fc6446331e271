"""FLICKER's contribution-aware 3DGS render path in PyTorch, with
hand-written Hopper kernels for every TPU kernel of the reference: the
entry-stream and dense CTU (Mini-Tile CAT) and the fused and full-sweep
blends.

Layout mirrors the JAX reference package module for module:
    core/      scene, camera, projection, Stage-1 compaction, CAT, blend,
               the staged RenderPlan (stream and dense dataflows, the AABB
               and OBB baselines), the legacy RenderConfig shim, PLY I/O,
               k-means clustering and contribution scores, and training
               (`core.training`: autograd through the all-"torch" plan)
    lod/       camera-dependent LOD: build, cluster selection, gather
    kernels/   CUDA kernels (csrc/), their wrappers and plain versions
    obs/       span tracing, the metrics registry and exporters
    checkpoint/  atomic step checkpoints in the reference's layout
    distributed/  the device mesh, the logical-axis rules, checkpoint/
               restart for training, shard-drop recovery and the
               straggler monitor
    serving/   RenderEngine (batched, optionally over a mesh: frame and
               tile sharding), telemetry, the deadline scheduler and the
               1080p workload
    configs/   the architecture registry (all ten of the reference's)
    models/    the LM, every family of the registry (dense, MoE with MLA,
               SSM, hybrid, enc-dec): forward, prefill and decode with
               in-place caches (`models.Model`)
    launch/    the serving CLI (`python -m repro_torch.launch.serve`,
               render and LM modes) and the one-device mesh
    convert    numpy -> port types (and a TrainState and LM params back),
               for parity tests and for carrying state across packages
"""
from repro_torch.core import (FLICKER_CONFIG, GSCORE_CONFIG, VANILLA_CONFIG,
                              GaussianScene, GridConfig, OverflowPolicy,
                              RasterConfig, RenderConfig, RenderPlan,
                              Renderer, ShardConfig, StreamConfig,
                              TestConfig,
                              SH_C0, load_ply, orbit_camera, random_scene,
                              save_ply, ssim)
from repro_torch.serving import RenderEngine, RenderRequest, hd1080_engine

__all__ = [
    "FLICKER_CONFIG", "GSCORE_CONFIG", "VANILLA_CONFIG", "RenderConfig",
    "GaussianScene", "GridConfig", "OverflowPolicy", "RasterConfig",
    "RenderPlan", "Renderer", "ShardConfig", "StreamConfig", "TestConfig",
    "orbit_camera",
    "random_scene", "SH_C0", "load_ply", "save_ply", "ssim", "RenderEngine",
    "RenderRequest", "hd1080_engine",
]
