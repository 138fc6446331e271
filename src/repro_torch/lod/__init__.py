"""Camera-dependent hierarchical LOD selection (pre-Stage-1 stage).

Offline, `build_lod` clusters the scene ("big Gaussians", §IV-A) and
accumulates per-cluster contribution mass over a probe camera set (§V-A
scores); online, `select_clusters` picks the clusters a camera needs
(frustum + projected footprint + contribution bound) and
`gather_subscene` compacts their members into a pow2-bucketed sub-scene
that the `RenderPlan` stream pipeline renders unchanged
(`RenderPlan.render_lod_with_stats`, `RenderEngine.register_scene(lod=)`).
"""
from repro_torch.lod.build import LODScene, build_lod
from repro_torch.lod.config import LODConfig
from repro_torch.lod.select import (gather_subscene, measure_lod_k_max,
                                    member_mask, select_clusters,
                                    selected_members, selection_bucket_for)

__all__ = [
    "LODConfig", "LODScene", "build_lod",
    "select_clusters", "member_mask", "selected_members",
    "selection_bucket_for", "gather_subscene", "measure_lod_k_max",
]
