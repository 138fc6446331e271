"""Request-level serving on one device: the scene registry and the 1080p
workload."""
from repro_torch.serving.engine import (FrameResult, RenderEngine,
                                        RenderRequest, scene_bucket)
from repro_torch.serving.workloads import (HD1080_GAUSSIANS, HD1080_HEIGHT,
                                           HD1080_WIDTH, HD_SCENE_KW,
                                           hd1080_cameras, hd1080_engine,
                                           register_hd1080_scene)

__all__ = [
    "FrameResult", "RenderEngine", "RenderRequest", "scene_bucket",
    "HD1080_GAUSSIANS", "HD1080_HEIGHT", "HD1080_WIDTH", "HD_SCENE_KW",
    "hd1080_cameras", "hd1080_engine", "register_hd1080_scene",
]
