"""Big-Gaussian clustering (paper §IV-A "Memory Access Optimization").

Groups spatially-near Gaussians into clusters ("big Gaussians") so frustum
culling runs per cluster, not per Gaussian, cutting off-chip traffic: only
the 10 geometric parameters of clusters that survive culling have their
member Gaussians fetched; the 45 color/SH parameters are fetched only for
Gaussians that additionally pass the intersection test.

A fixed-iteration k-means over Gaussian means; cluster bounding spheres
cover member 3-sigma extents. Sized for multi-million-Gaussian scenes (the
LOD build path): distances use the expanded |p|^2 - 2 p.c + |c|^2 form,
written as explicit float32 products and sums (no matrix-multiply library
call, which may round through TF32), one (block, C) distance matrix per
point block of `ASSIGN_BLOCK`; the center fit runs on a subsample of
`FIT_SAMPLE` points when N exceeds it (the final assignment covers every
Gaussian).

Deterministic: the fit subsample and the initial centers come from an
explicit `torch.Generator` (or are handed in as `init`), and every float
sum over a segment (`segment_sum`) adds its members one after another in
index order, so two runs on one device give the same bits (a scatter-add
of float32 on CUDA uses atomics and does not).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.gaussians import GaussianScene

GEOM_PARAMS = 10   # mean(3) scale(3) quat(4)  -- fetched for culling
COLOR_PARAMS = 45  # SH coeffs etc.            -- fetched lazily

ASSIGN_BLOCK = 1 << 14   # points per chunked assignment block
FIT_SAMPLE = 1 << 16     # center-fit subsample bound (assignment stays full)


class Clustering(NamedTuple):
    centers: torch.Tensor   # (C, 3)
    radii: torch.Tensor     # (C,) bounding-sphere radius incl. 3-sigma
    assign: torch.Tensor    # (N,) cluster id per Gaussian
    counts: torch.Tensor    # (C,) float32 members per cluster


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment sums of the rows of `values`, starting from `init`
    (zeros when None): segment s adds its rows one after another in index
    order, the order of a sequential scatter-add. Order-fixed, so the same
    bits on every run; one step per member of the largest segment, each an
    O(num_segments) gather and add."""
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rows = values[order]
    out = (torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype,
                       device=values.device)
           if init is None else init.clone())
    if rows.shape[0] == 0:
        return out
    last = rows.shape[0] - 1
    shape = (-1,) + (1,) * (values.dim() - 1)
    for j in range(int(counts.max())):
        live = (counts > j).reshape(shape)
        step = rows[(starts + j).clamp_max(last)]
        out = out + torch.where(live, step, torch.zeros_like(step))
    return out


def _assign_block(pts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(B, 3) points -> (B,) nearest-center ids via one (B, C) distance
    matrix |p|^2 - (2p).c + |c|^2, summed over x, y, z in that order."""
    p2 = 2.0 * pts
    pp = (pts[:, 0:1] * pts[:, 0:1] + pts[:, 1:2] * pts[:, 1:2]) \
        + pts[:, 2:3] * pts[:, 2:3]
    cc = (centers[:, 0] * centers[:, 0] + centers[:, 1] * centers[:, 1]) \
        + centers[:, 2] * centers[:, 2]
    dot = (p2[:, 0:1] * centers[:, 0] + p2[:, 1:2] * centers[:, 1]) \
        + p2[:, 2:3] * centers[:, 2]
    return torch.argmin((pp - dot) + cc[None, :], dim=1)


def _assign_all(pts: torch.Tensor, centers: torch.Tensor,
                block: int = ASSIGN_BLOCK) -> torch.Tensor:
    """Chunked nearest-center assignment: (N,) ids, O(block x C) live."""
    return torch.cat([_assign_block(pts[s:s + block], centers)
                      for s in range(0, pts.shape[0], block)])


def draw_init(n: int, num_clusters: int,
              generator: Optional[torch.Generator] = None, device=None):
    """(fit_idx or None, center_idx) for `kmeans_clusters`: a FIT_SAMPLE
    subsample without replacement when n exceeds it, then `num_clusters`
    distinct initial centers among the fit points. Drawn from `generator`
    (seed 0 on `device` when None) and returned on `device`."""
    g = generator
    if g is None:
        g = torch.Generator(device=device or "cpu").manual_seed(0)
    fit_idx = None
    m = n
    if n > FIT_SAMPLE:
        fit_idx = torch.randperm(n, generator=g,
                                 device=g.device)[:FIT_SAMPLE].to(device)
        m = FIT_SAMPLE
    center_idx = torch.randperm(m, generator=g,
                                device=g.device)[:num_clusters].to(device)
    return fit_idx, center_idx


def kmeans_clusters(scene: GaussianScene, num_clusters: int, iters: int = 8,
                    generator: Optional[torch.Generator] = None,
                    init=None) -> Clustering:
    """Fixed-iteration k-means over the scene's means.

    init: (fit_idx, center_idx) — the fit subsample's point ids (None = all
    points) and the initial centers' ids among the fit points; drawn from
    `generator` (`draw_init`) when None."""
    pts = scene.means                                   # (N, 3)
    n = pts.shape[0]
    if init is None:
        init = draw_init(n, num_clusters, generator, pts.device)
    fit_idx, center_idx = init
    fit = pts if fit_idx is None else pts[fit_idx.to(pts.device)]
    centers = fit[center_idx.to(pts.device)]
    for _ in range(iters):
        assign = _assign_all(fit, centers)              # (m,)
        sums = segment_sum(fit, assign, num_clusters)
        cnt = torch.bincount(assign, minlength=num_clusters).to(pts.dtype)
        centers = torch.where(cnt[:, None] > 0,
                              sums / torch.clamp_min(cnt[:, None], 1),
                              centers)
    assign = _assign_all(pts, centers)                  # every Gaussian
    counts = torch.bincount(assign, minlength=num_clusters).to(pts.dtype)
    d = pts - centers[assign]
    reach = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                       + d[:, 2] * d[:, 2])
    reach = reach + 3.0 * torch.exp(scene.log_scales.max(dim=-1).values)
    radii = torch.full((num_clusters,), float("-inf"), dtype=pts.dtype,
                       device=pts.device).scatter_reduce_(
        0, assign, reach, "amax")
    radii = torch.where(counts > 0, radii, torch.zeros_like(radii))
    return Clustering(centers, radii, assign, counts)


def cluster_frustum_cull(cl: Clustering, camera) -> torch.Tensor:
    """(C,) bool — conservative sphere-vs-frustum test in camera space."""
    t = (camera.R_wc @ cl.centers.T).T + camera.t_wc
    z = t[:, 2]
    vis_z = z + cl.radii > camera.near
    # Side planes via tan-half-fov cones, inflated by r/cos(half-fov)
    # (the exact sphere-vs-plane distance).
    inflate_x = torch.sqrt(1.0 + camera.tan_half_fov_x ** 2)
    inflate_y = torch.sqrt(1.0 + camera.tan_half_fov_y ** 2)
    zn = torch.clamp_min(z, camera.near)
    margin_x = camera.tan_half_fov_x * zn + cl.radii * inflate_x
    margin_y = camera.tan_half_fov_y * zn + cl.radii * inflate_y
    vis_x = torch.abs(t[:, 0]) < margin_x
    vis_y = torch.abs(t[:, 1]) < margin_y
    return vis_z & vis_x & vis_y & (cl.counts > 0)


def memory_traffic_model(cl: Clustering, cluster_vis: torch.Tensor,
                         gauss_pass_intersection: torch.Tensor,
                         bytes_per_param: int = 2) -> dict:
    """Off-chip traffic with and without clustering (the paper's argument).

    gauss_pass_intersection: (N,) bool — Gaussians needing color params.
    Returns 0-d byte counts."""
    n = cl.assign.shape[0]
    gauss_vis = cluster_vis[cl.assign]
    geom = GEOM_PARAMS * bytes_per_param
    col = COLOR_PARAMS * bytes_per_param
    return dict(
        # no clustering: every Gaussian's geometry fetched for culling
        bytes_no_cluster=torch.tensor(float(n * geom), dtype=torch.float32,
                                      device=cl.assign.device)
        + gauss_pass_intersection.sum() * col,
        # clustering: cluster centers (one geom record each) + members of
        # visible clusters only
        bytes_cluster=cl.centers.shape[0] * geom
        + gauss_vis.sum() * geom
        + (gauss_pass_intersection & gauss_vis).sum() * col,
    )
