"""LOD-stage configuration.

`LODConfig` is the hashable knob set of the camera-dependent LOD stage
(`repro_torch.lod`): the offline build parameters (cluster count, k-means
iterations, probe scoring capacity) and the online selection thresholds
(projected footprint, contribution-mass floor), plus the pow2 selection
bucket the gathered sub-scene is padded to. It rides on
`core.renderer.RenderPlan.lod` — a frozen dataclass, so it joins the plan
hash and thereby the serving engine's plan-cache key exactly like the spill
pass bucket does. `RenderPlan.lod = None` (the default) leaves every existing
render path untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class LODConfig:
    """Camera-dependent hierarchical LOD selection (pre-Stage-1 stage).

    Build-time (consumed by `repro_torch.lod.build_lod`):
      num_clusters    k-means cluster ("big Gaussian") count.
      kmeans_iters    fixed k-means iterations (deterministic under a
                      generator).
      probe_k_max     per-tile list capacity when scoring contribution mass
                      over the probe cameras (`pruning.contribution_scores`).
      probe_passes    overflow-aware scoring passes: probe tiles whose
                      survivor lists exceed probe_k_max spill into extra
                      scored passes instead of dropping tail mass.

    Select-time (consumed by `repro_torch.lod.select_clusters`):
      min_footprint_px  drop visible clusters whose bounding sphere projects
                        below this many pixels of radius (sub-pixel detail
                        for this camera).
      mass_floor        drop clusters whose probe-accumulated contribution
                        mass is below mass_floor x total mass (occluded /
                        never-contributing regions). 0.0 disables the test.
      min_bucket        smallest selection bucket (pow2) the gathered
                        sub-scene is padded to.
      selection_bucket  static gather capacity (pow2) of the compact
                        sub-scene. None = derived per frame from the
                        selected member count (host-side); the serving
                        engine pins it per batch so it keys the plan
                        cache.
    """
    num_clusters: int = 256
    kmeans_iters: int = 8
    probe_k_max: int = 512
    probe_passes: int = 4
    min_footprint_px: float = 1.0
    mass_floor: float = 1e-5
    min_bucket: int = 256
    selection_bucket: Optional[int] = None

    def __post_init__(self):
        if self.num_clusters < 1:
            raise ValueError(f"num_clusters must be >= 1, "
                             f"got {self.num_clusters}")
        if self.kmeans_iters < 1:
            raise ValueError(f"kmeans_iters must be >= 1, "
                             f"got {self.kmeans_iters}")
        if self.probe_k_max < 1:
            raise ValueError(f"probe_k_max must be >= 1, "
                             f"got {self.probe_k_max}")
        if self.probe_passes < 1:
            raise ValueError(f"probe_passes must be >= 1, "
                             f"got {self.probe_passes}")
        if self.min_footprint_px < 0.0:
            raise ValueError(f"min_footprint_px must be >= 0, "
                             f"got {self.min_footprint_px}")
        if not 0.0 <= self.mass_floor < 1.0:
            raise ValueError(f"mass_floor must be in [0, 1), "
                             f"got {self.mass_floor}")
        if not _is_pow2(self.min_bucket):
            raise ValueError(f"min_bucket must be a power of two, "
                             f"got {self.min_bucket}")
        if self.selection_bucket is not None and \
                not _is_pow2(self.selection_bucket):
            raise ValueError(f"selection_bucket must be a power of two, "
                             f"got {self.selection_bucket}")
