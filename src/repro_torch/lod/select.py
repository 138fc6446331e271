"""Online LOD selection: per-camera cluster picking + compact gather.

`select_clusters` runs the coarse, cluster-granular tests the paper puts
before the fine-grained per-Gaussian pipeline: the conservative
sphere-vs-frustum cull (`core.clustering.cluster_frustum_cull`), a
projected-footprint test (clusters whose bounding sphere lands below
`min_footprint_px` pixels of radius are sub-pixel detail for this camera),
and a contribution bound (clusters whose probe-accumulated mass is below
`mass_floor` x total never contributed over the probe set — occluded or
inert regions). `gather_subscene` then compacts the selected clusters'
members — contiguous blocks, thanks to the build-time reorder — into a
pow2-bucketed `GaussianScene` that the `RenderPlan` stream pipeline renders
unchanged (K1 and K2 on the "cuda" backends).
"""
from __future__ import annotations

import torch

from repro_torch.core.clustering import Clustering, cluster_frustum_cull
from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.renderer import GridConfig, measure_k_max, next_pow2
from repro_torch.lod.build import LODScene
from repro_torch.lod.config import LODConfig


def select_clusters(lod: LODScene, camera, cfg: LODConfig) -> torch.Tensor:
    """(C,) bool — clusters this camera renders.

    frustum-visible AND projected footprint >= min_footprint_px AND
    contribution mass >= mass_floor x total probe mass. All three tests are
    cluster-granular (O(C), not O(N))."""
    cl = Clustering(lod.centers, lod.radii, lod.member_cluster, lod.counts)
    visible = cluster_frustum_cull(cl, camera)
    t = (camera.R_wc @ lod.centers.T).T + camera.t_wc
    z = torch.clamp_min(t[:, 2], camera.near)
    focal = 0.5 * (camera.fx + camera.fy)
    footprint_px = focal * lod.radii / z
    total = torch.sum(lod.mass)
    enough_mass = lod.mass >= cfg.mass_floor * total
    return visible & (footprint_px >= cfg.min_footprint_px) & enough_mass


def member_mask(lod: LODScene, selected: torch.Tensor) -> torch.Tensor:
    """(Npad,) bool — members of selected clusters (padding never selects)."""
    cluster = lod.member_cluster
    return (cluster >= 0) & selected[cluster.clamp_min(0).long()]


def selected_members(lod: LODScene, selected: torch.Tensor) -> torch.Tensor:
    """() int32 — member count of the selected clusters."""
    return torch.sum(torch.where(selected, lod.counts,
                                 torch.zeros_like(lod.counts))
                     ).to(torch.int32)


def selection_bucket_for(count: int, cfg: LODConfig, cap: int) -> int:
    """Pow2 gather capacity for a selected member count (host-side).

    next_pow2(count), floored at cfg.min_bucket, capped at the padded
    member count — the value the serving engine pins into
    `LODConfig.selection_bucket` per batch (it keys the plan cache)."""
    return min(max(next_pow2(max(int(count), 1)), cfg.min_bucket), cap)


def gather_subscene(lod: LODScene, selected: torch.Tensor,
                    bucket: int) -> tuple[GaussianScene, torch.Tensor]:
    """Compact the selected clusters' members into a `bucket`-sized scene.

    Returns (sub-scene of exactly `bucket` Gaussians, () int32 selected
    member count). Selected members keep their cluster-contiguous build
    order, so each selected cluster is one contiguous block of the output;
    slots past the selected count are inert padding (member 0's geometry
    at opacity logit -30, culled for every camera, like
    `core.gaussians.pad_scene`). Members past `bucket` are dropped — the
    serving engine sizes the bucket from the count first, so that only
    happens with an explicitly pinned too-small `selection_bucket`."""
    if not 1 <= bucket <= lod.n_padded:
        raise ValueError(f"selection bucket {bucket} outside "
                         f"[1, {lod.n_padded}]")
    mask = member_mask(lod, selected)                    # (Npad,)
    take = torch.nonzero(mask).squeeze(1)[:bucket]       # in member order
    src = torch.zeros((bucket,), dtype=torch.long, device=mask.device)
    src[:take.shape[0]] = take
    valid = torch.arange(bucket, device=mask.device) < take.shape[0]
    s = lod.scene
    sub = GaussianScene(
        means=s.means[src], log_scales=s.log_scales[src], quats=s.quats[src],
        opacity_logits=torch.where(valid, s.opacity_logits[src],
                                   torch.full_like(s.opacity_logits[src],
                                                   -30.0)),
        colors=s.colors[src])
    return sub, mask.sum().to(torch.int32)


def gather_selection(lod: LODScene, selected: torch.Tensor, cfg: LODConfig,
                     count) -> tuple[GaussianScene, int]:
    """(sub-scene, bucket) for a (C,) selection: the gather capacity is
    `cfg.selection_bucket` when pinned, else `selection_bucket_for` of
    `count` (the selected member count, an int or a () tensor, read on the
    host only when the bucket is not pinned)."""
    bucket = (cfg.selection_bucket if cfg.selection_bucket is not None
              else selection_bucket_for(int(count), cfg, lod.n_padded))
    sub, _ = gather_subscene(lod, selected, bucket)
    return sub, bucket


def measure_lod_k_max(lod: LODScene, cameras, cfg: LODConfig, *,
                      grid: GridConfig = GridConfig(),
                      cap: int | None = None) -> int:
    """Stage-1 survivor bound of the selected sub-scenes over the probes.

    The LOD analogue of `core.renderer.measure_k_max`: for each probe
    camera, run the selection and gather this camera would serve with and
    measure the longest Stage-1 tile list of the resulting sub-scene.
    Selection only removes Gaussians, so the bound is <= the full scene's,
    usually far below it."""
    cameras = list(cameras)
    if not cameras:
        raise ValueError("measure_lod_k_max needs at least one probe camera")
    k = 1
    for cam in cameras:
        sel = select_clusters(lod, cam, cfg)
        bucket = selection_bucket_for(
            int(selected_members(lod, sel)), cfg, lod.n_padded)
        sub, _ = gather_subscene(lod, sel, bucket)
        k = max(k, measure_k_max(sub, [cam], grid=grid, cap=cap))
    return k
