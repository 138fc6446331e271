"""FLICKER render core in PyTorch: the contribution-aware stream path."""
from repro_torch.core.gaussians import (ALPHA_MIN, GaussianScene, Projected,
                                        pad_scene, project, random_scene)
from repro_torch.core.camera import (Camera, default_camera, orbit_camera,
                                     resize_camera)
from repro_torch.core.culling import TileGrid, aabb_mask
from repro_torch.core.cat import (SamplingMode, entry_cat_mask,
                                  pr_gaussian_weight)
from repro_torch.core.hierarchy import StreamHierarchyOut, stream_entry_test
from repro_torch.core.renderer import (GridConfig, OverflowPolicy,
                                       ProjectedScene, RasterConfig,
                                       RenderPlan, Renderer, StreamConfig,
                                       StreamOverflowError,
                                       StreamOverflowWarning, TestConfig,
                                       TileStream, cat_mask_elems,
                                       measure_k_max)
from repro_torch.core.metrics import psnr
from repro_torch.core.precision import (FULL_FP16, FULL_FP32, FULL_FP8,
                                        MIXED, PrecisionScheme)

__all__ = [
    "ALPHA_MIN", "GaussianScene", "Projected", "pad_scene", "project",
    "random_scene", "Camera", "default_camera", "orbit_camera",
    "resize_camera", "TileGrid", "aabb_mask", "SamplingMode",
    "entry_cat_mask", "pr_gaussian_weight", "StreamHierarchyOut",
    "stream_entry_test", "GridConfig", "OverflowPolicy", "ProjectedScene",
    "RasterConfig", "RenderPlan", "Renderer", "StreamConfig",
    "StreamOverflowError", "StreamOverflowWarning", "TestConfig",
    "TileStream", "cat_mask_elems", "measure_k_max", "psnr",
    "FULL_FP16", "FULL_FP32", "FULL_FP8", "MIXED", "PrecisionScheme",
]
