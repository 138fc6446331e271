"""FLICKER render core in PyTorch: the contribution-aware stream path, the
dense-mask oracle and the AABB/OBB baselines."""
from repro_torch.core.gaussians import (ALPHA_MIN, GaussianScene, Projected,
                                        pad_scene, project, random_scene)
from repro_torch.core.camera import (Camera, default_camera, orbit_camera,
                                     resize_camera)
from repro_torch.core.culling import (TileGrid, aabb_mask, intersection_mask,
                                      obb_mask)
from repro_torch.core.cat import (SamplingMode, entry_cat_mask,
                                  exact_minitile_mask, minitile_cat_mask,
                                  pr_gaussian_weight)
from repro_torch.core.hierarchy import (HierarchyOut, StreamHierarchyOut,
                                        baseline_masks, hierarchical_test,
                                        stream_entry_test)
from repro_torch.core.renderer import (GridConfig, OverflowPolicy,
                                       ProjectedScene, RasterConfig,
                                       RenderPlan, Renderer, StreamConfig,
                                       StreamOverflowError,
                                       StreamOverflowWarning, TestConfig,
                                       TileStream, cat_mask_elems,
                                       measure_k_max)
from repro_torch.core.metrics import psnr
from repro_torch.core.pipeline import (FLICKER_CONFIG, GSCORE_CONFIG,
                                       VANILLA_CONFIG, RenderConfig)
from repro_torch.core.precision import (FULL_FP16, FULL_FP32, FULL_FP8,
                                        MIXED, PrecisionScheme)

__all__ = [
    "ALPHA_MIN", "GaussianScene", "Projected", "pad_scene", "project",
    "random_scene", "Camera", "default_camera", "orbit_camera",
    "resize_camera", "TileGrid", "aabb_mask", "intersection_mask",
    "obb_mask", "SamplingMode", "entry_cat_mask", "exact_minitile_mask",
    "minitile_cat_mask", "pr_gaussian_weight", "HierarchyOut",
    "StreamHierarchyOut", "baseline_masks", "hierarchical_test",
    "stream_entry_test", "GridConfig", "OverflowPolicy", "ProjectedScene",
    "RasterConfig", "RenderPlan", "Renderer", "StreamConfig",
    "StreamOverflowError", "StreamOverflowWarning", "TestConfig",
    "TileStream", "cat_mask_elems", "measure_k_max", "psnr",
    "FULL_FP16", "FULL_FP32", "FULL_FP8", "MIXED", "PrecisionScheme",
    "FLICKER_CONFIG", "GSCORE_CONFIG", "VANILLA_CONFIG", "RenderConfig",
]
