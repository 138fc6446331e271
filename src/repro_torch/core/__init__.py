"""FLICKER render core in PyTorch: the contribution-aware stream path, the
dense-mask oracle and the AABB/OBB baselines."""
from repro_torch.core.gaussians import (ALPHA_MIN, GaussianScene, Projected,
                                        pad_scene, project, random_scene)
from repro_torch.core.camera import (Camera, default_camera, orbit_camera,
                                     resize_camera, stack_cameras)
from repro_torch.core.culling import (TileGrid, aabb_mask, intersection_mask,
                                      obb_mask)
from repro_torch.core.cat import (SamplingMode, entry_cat_mask,
                                  exact_minitile_mask, minitile_cat_mask,
                                  pr_gaussian_weight)
from repro_torch.core.hierarchy import (HierarchyOut, StreamHierarchyOut,
                                        baseline_masks, hierarchical_test,
                                        stream_entry_test,
                                        stream_hierarchical_test)
from repro_torch.core.renderer import (GridConfig, OverflowPolicy,
                                       ProjectedScene, RasterConfig,
                                       RenderPlan, Renderer, ShardConfig,
                                       StageSpec, StreamConfig,
                                       StreamOverflowError,
                                       StreamOverflowWarning, TestConfig,
                                       TileStream, as_plan, cat_mask_elems,
                                       frame_counters, measure_k_max)
from repro_torch.core.io import SH_C0, load_ply, save_ply
from repro_torch.core.metrics import psnr, ssim
from repro_torch.core.coherence import (CoherenceConfig, FrameCache,
                                        camera_delta, render_incremental,
                                        tile_cover_rects, tile_fingerprints)
from repro_torch.core.pipeline import (FLICKER_CONFIG, GSCORE_CONFIG,
                                       VANILLA_CONFIG, RenderConfig, render,
                                       render_batch_with_stats,
                                       render_with_stats)
from repro_torch.core.precision import (FULL_FP16, FULL_FP32, FULL_FP8,
                                        MIXED, PrecisionScheme)

__all__ = [
    "ALPHA_MIN", "GaussianScene", "Projected", "pad_scene", "project",
    "random_scene", "Camera", "default_camera", "orbit_camera",
    "resize_camera", "stack_cameras", "TileGrid", "aabb_mask", "intersection_mask",
    "obb_mask", "SamplingMode", "entry_cat_mask", "exact_minitile_mask",
    "minitile_cat_mask", "pr_gaussian_weight", "HierarchyOut",
    "StreamHierarchyOut", "baseline_masks", "hierarchical_test",
    "stream_entry_test", "stream_hierarchical_test", "GridConfig",
    "OverflowPolicy", "ProjectedScene",
    "RasterConfig", "RenderPlan", "Renderer", "ShardConfig", "StageSpec",
    "StreamConfig", "as_plan",
    "StreamOverflowError", "StreamOverflowWarning", "TestConfig",
    "TileStream", "cat_mask_elems", "frame_counters", "measure_k_max",
    "SH_C0", "load_ply", "save_ply", "psnr", "ssim", "CoherenceConfig",
    "FrameCache", "camera_delta",
    "render_incremental", "tile_cover_rects", "tile_fingerprints",
    "FULL_FP16", "FULL_FP32", "FULL_FP8", "MIXED", "PrecisionScheme",
    "FLICKER_CONFIG", "GSCORE_CONFIG", "VANILLA_CONFIG", "RenderConfig",
    "render", "render_batch_with_stats", "render_with_stats",
]
