"""Offline LOD build: cluster the scene, accumulate probe contribution mass.

`build_lod` turns a `GaussianScene` plus a probe camera set into a
`LODScene` — the cluster table (`core.clustering.kmeans_clusters` centers
and bounding spheres) annotated with each cluster's contribution mass (the
transmittance-weighted alpha its members deposit over the probes,
`core.pruning.contribution_scores`), with the scene's Gaussians reordered
so every cluster's members are contiguous and the member axis pow2-padded
with inert Gaussians. Contiguity is the paper's §IV-A memory-access
argument (one visible cluster = one contiguous fetch) and makes the online
gather (`repro_torch.lod.select.gather_subscene`) an order-preserving
compaction over a sorted axis.

The build runs on the device of the scene it is given and is deterministic
there under a fixed generator (or a given `init`): k-means draws from the
generator, and the centers, scores and masses are order-fixed segment sums
(`core.clustering.segment_sum`), never float atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.clustering import kmeans_clusters, segment_sum
from repro_torch.core.gaussians import GaussianScene, pad_scene
from repro_torch.core.pruning import contribution_scores
from repro_torch.core.renderer import GridConfig, next_pow2
from repro_torch.lod.config import LODConfig


@dataclasses.dataclass(frozen=True)
class LODScene:
    """Cluster table + cluster-contiguous, pow2-padded member scene.

    scene.n is the pow2-padded member count; members `n_real..` are inert
    padding (`core.gaussians.pad_scene`) assigned to no cluster
    (member_cluster -1), so they can never be selected. For each cluster c,
    members `starts[c] .. starts[c] + counts[c]` form one contiguous block.
    """
    scene: GaussianScene          # reordered + padded to pow2 member count
    member_cluster: torch.Tensor  # (Npad,) int32 cluster id, -1 for padding
    centers: torch.Tensor         # (C, 3) cluster centroids
    radii: torch.Tensor           # (C,) bounding-sphere radii (3-sigma incl.)
    counts: torch.Tensor          # (C,) int32 members per cluster
    starts: torch.Tensor          # (C,) int32 member-block offsets
    mass: torch.Tensor            # (C,) probe-accumulated contribution mass
    n_real: int

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def n_padded(self) -> int:
        return self.scene.n

    def to(self, device) -> "LODScene":
        """The same LOD scene with every tensor on `device`."""
        return dataclasses.replace(
            self, scene=self.scene.to(device), **{
                f: getattr(self, f).to(device)
                for f in ("member_cluster", "centers", "radii", "counts",
                          "starts", "mass")})


def build_lod(scene: GaussianScene, probe_cameras,
              cfg: LODConfig = LODConfig(), *,
              grid: GridConfig = GridConfig(),
              generator: Optional[torch.Generator] = None,
              init=None) -> LODScene:
    """Cluster `scene` and score the clusters over `probe_cameras`.

    Offline (the reorder changes the member layout). `grid` supplies the
    tile shape used for probe scoring; each probe camera's own resolution
    sizes its grid, and probes may mix resolutions. `generator` / `init`
    go to `kmeans_clusters` (seed 0 on the scene's device when both are
    None)."""
    probe_cameras = list(probe_cameras)
    if not probe_cameras:
        raise ValueError("build_lod needs at least one probe camera — "
                         "cluster contribution mass is measured, not "
                         "assumed (an empty probe set would zero every "
                         "cluster's mass and select nothing)")
    n = scene.n
    device = scene.means.device
    c = min(cfg.num_clusters, n)
    cl = kmeans_clusters(scene, c, iters=cfg.kmeans_iters,
                         generator=generator, init=init)

    # Per-Gaussian contribution mass over the probes, grouped by resolution
    # so cameras sharing a grid shape share one scoring call.
    by_res: dict[tuple, list] = {}
    for cam in probe_cameras:
        by_res.setdefault((cam.height, cam.width), []).append(cam.to(device))
    scores = torch.zeros((n,), dtype=torch.float32, device=device)
    for (h, w), cams in sorted(by_res.items()):
        g = grid.with_resolution(h, w).make()
        scores = scores + contribution_scores(
            scene, cams, g, k_max=cfg.probe_k_max, passes=cfg.probe_passes)
    mass = segment_sum(scores, cl.assign, c)

    # Reorder members cluster-contiguous (stable: the original order is
    # kept within a cluster), then pow2-pad with inert Gaussians outside
    # every cluster.
    order = torch.argsort(cl.assign, stable=True)
    reordered = GaussianScene(*(x[order] for x in (
        scene.means, scene.log_scales, scene.quats, scene.opacity_logits,
        scene.colors)))
    counts = cl.counts.to(torch.int32)
    starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    n_pad = next_pow2(n)
    member_cluster = torch.cat([
        cl.assign[order].to(torch.int32),
        torch.full((n_pad - n,), -1, dtype=torch.int32, device=device)])
    return LODScene(
        scene=pad_scene(reordered, n_pad),
        member_cluster=member_cluster,
        centers=cl.centers,
        radii=cl.radii,
        counts=counts,
        starts=starts,
        mass=mass,
        n_real=n,
    )
