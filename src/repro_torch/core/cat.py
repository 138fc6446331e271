"""Mini-Tile Contribution-Aware Test (paper §II-A, §III).

A 4×4 mini-tile is marked intersected by a Gaussian iff at least one of its
leader pixels receives alpha >= 1/255, i.e.

    ln(255 * o) > E,   E = ½ Δᵀ Σ'⁻¹ Δ,  Δ = p_leader − μ'       (Eq. 2)

Dense sampling tests the mini-tile's 4 corner pixels (one Pixel Rectangle
per mini-tile); sparse sampling tests the 2 main-diagonal corners. Alg. 1
shares the separable terms between the corners of a PR. SMOOTH_FOCUSED
uses dense sampling for smooth Gaussians and sparse for spiky ones.
"""
from __future__ import annotations

import enum

import torch

from repro_torch.core.gaussians import Projected, classify_spiky
from repro_torch.core.culling import TileGrid
from repro_torch.core.precision import PrecisionScheme, FULL_FP32


class SamplingMode(enum.Enum):
    UNIFORM_DENSE = "uniform_dense"
    UNIFORM_SPARSE = "uniform_sparse"
    SMOOTH_FOCUSED = "smooth_focused"   # dense for smooth, sparse for spiky
    SPIKY_FOCUSED = "spiky_focused"     # dense for spiky, sparse for smooth


def pr_gaussian_weight(mu, conic, p_top, p_bot,
                       prec: PrecisionScheme = FULL_FP32) -> torch.Tensor:
    """Alg. 1: weights E0..E3 of a Gaussian at the 4 corners of a PR.

    mu (..., 2), conic (..., 3) = (Σ⁻¹xx, Σ⁻¹xy, Σ⁻¹yy), p_top/p_bot (..., 2)
    main-diagonal pixel coordinates. Returns E (..., 4) in corner order
    [top-left, (xbot, ytop), (xtop, ybot), bottom-right]. One quantization
    per step, in the order of the CTU datapath.
    """
    qc = prec.q_coord
    mu_q = qc(mu)
    cxx, cxy, cyy = qc(conic[..., 0]), qc(conic[..., 1]), qc(conic[..., 2])
    # line 1 — subtract at coord precision, result converted to delta prec
    d_top = prec.q_delta(qc(p_top) - mu_q)
    d_bot = prec.q_delta(qc(p_bot) - mu_q)
    dtx, dty = d_top[..., 0], d_top[..., 1]
    dbx, dby = d_bot[..., 0], d_bot[..., 1]
    # lines 2-3: separable terms (multipliers at mul precision)
    qm, qa = prec.q_mul, prec.q_acc
    s_top_x = qm(qm(0.5 * qm(dtx * dtx)) * cxx)
    s_top_y = qm(qm(0.5 * qm(dty * dty)) * cyy)
    s_bot_x = qm(qm(0.5 * qm(dbx * dbx)) * cxx)
    s_bot_y = qm(qm(0.5 * qm(dby * dby)) * cyy)
    # lines 4-5: cross terms
    t0 = qm(qm(dtx * dty) * cxy)
    t1 = qm(qm(dbx * dty) * cxy)
    t2 = qm(qm(dtx * dby) * cxy)
    t3 = qm(qm(dbx * dby) * cxy)
    # lines 6-7: adders at acc precision
    e0 = qa(qa(s_top_x + s_top_y) + t0)
    e1 = qa(qa(s_bot_x + s_top_y) + t1)
    e2 = qa(qa(s_top_x + s_bot_y) + t2)
    e3 = qa(qa(s_bot_x + s_bot_y) + t3)
    return torch.stack([e0, e1, e2, e3], dim=-1)


def select_mode(ok: torch.Tensor, spiky: torch.Tensor,
                mode: SamplingMode) -> torch.Tensor:
    """Per-corner pass flags (..., 4) -> mini-tile hit (...) under `mode`;
    `spiky` broadcasts against ok[..., 0]."""
    dense_hit = ok.any(dim=-1)
    sparse_hit = ok[..., 0] | ok[..., 3]               # main diagonal only
    if mode == SamplingMode.UNIFORM_DENSE:
        return dense_hit
    if mode == SamplingMode.UNIFORM_SPARSE:
        return sparse_hit
    if mode == SamplingMode.SMOOTH_FOCUSED:
        return torch.where(spiky, sparse_hit, dense_hit)
    if mode == SamplingMode.SPIKY_FOCUSED:
        return torch.where(spiky, dense_hit, sparse_hit)
    raise ValueError(mode)


def leader_corners(grid: TileGrid, device="cpu"):
    """(Mt, 2) float32 tile-local main-diagonal leader coordinates (pixel
    centers) of each mini-tile PR: (p_top, p_bot)."""
    local = grid.minitile_local_origins(device).to(torch.float32)
    m = float(grid.minitile - 1)
    return local + 0.5, local + (m + 0.5)


def _pr_pass_mask(proj: Projected, p_top: torch.Tensor, p_bot: torch.Tensor,
                  prec: PrecisionScheme) -> torch.Tensor:
    """(R, N, 4) bool: corner c of the PR (p_top[r], p_bot[r]) passes for
    Gaussian n. The shared LHS ln(255 o) is computed once per Gaussian."""
    lhs = torch.log(255.0 * torch.clamp_min(proj.opacity, 1e-12))   # (N,)
    E = pr_gaussian_weight(proj.mean2d[None, :, :], proj.conic[None, :, :],
                           p_top[:, None, :], p_bot[:, None, :], prec)
    ok = lhs[None, :, None] > E * (1.0 - prec.slack)
    return ok & proj.in_frustum[None, :, None]


GAUSS_CHUNK_ELEMS = 1 << 25   # bound on the (M, chunk, 4) corner weights
#                               live at once: `minitile_cat_mask` blocks
#                               over Gaussians.


def minitile_cat_mask(proj: Projected, grid: TileGrid,
                      mode: SamplingMode = SamplingMode.UNIFORM_DENSE,
                      prec: PrecisionScheme = FULL_FP32,
                      spiky_threshold: float = 3.0) -> torch.Tensor:
    """(num_minitiles, N) bool: mini-tile m processes Gaussian n.

    Dense sampling tests the mini-tile's 4 corners; sparse sampling its 2
    main-diagonal corners (the same PR's lanes 0 and 3). The Gaussians are
    taken in blocks that keep the (M, block, 4) weights under
    `GAUSS_CHUNK_ELEMS`; columns are independent, so blocking changes no
    bit. The plain version of the dense PRTU kernel's function."""
    device = proj.mean2d.device
    origins = grid.minitile_origins(device).to(torch.float32)     # (M, 2)
    m = float(grid.minitile - 1)
    p_top, p_bot = origins + 0.5, origins + (m + 0.5)
    n = proj.mean2d.shape[0]
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)      # (N,)
    chunk = max(1, GAUSS_CHUNK_ELEMS // (4 * p_top.shape[0]))
    out = torch.empty((p_top.shape[0], n), dtype=torch.bool, device=device)
    for s in range(0, n, chunk):
        sub = Projected(*(x[s:s + chunk] for x in proj))
        corners = _pr_pass_mask(sub, p_top, p_bot, prec)          # (M, c, 4)
        out[:, s:s + chunk] = select_mode(corners,
                                          spiky[None, s:s + chunk], mode)
    return out


def exact_minitile_mask(proj: Projected, grid: TileGrid) -> torch.Tensor:
    """Oracle: the mini-tile truly contains a contributing pixel (all of its
    pixels tested). (M, N) bool, O(M·P·N) memory — tests only."""
    device = proj.mean2d.device
    origins = grid.minitile_origins(device).to(torch.float32)     # (M, 2)
    mt = grid.minitile
    r = torch.arange(mt, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], -1) + 0.5  # (P, 2)
    pix = origins[:, None, :] + offs[None, :, :]                  # (M, P, 2)
    d = pix[:, :, None, :] - proj.mean2d[None, None, :, :]        # (M,P,N,2)
    cxx, cxy, cyy = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
    E = (0.5 * (cxx * d[..., 0] ** 2 + cyy * d[..., 1] ** 2)
         + cxy * d[..., 0] * d[..., 1])
    lhs = torch.log(255.0 * torch.clamp_min(proj.opacity, 1e-12))
    hit = (lhs[None, None, :] > E).any(dim=1)                     # (M, N)
    return hit & proj.in_frustum[None, :]


def entry_cat_mask(proj: Projected, grid: TileGrid, lists: torch.Tensor,
                   valid: torch.Tensor,
                   mode: SamplingMode = SamplingMode.UNIFORM_DENSE,
                   prec: PrecisionScheme = FULL_FP32,
                   spiky_threshold: float = 3.0,
                   tile_origins: torch.Tensor | None = None) -> torch.Tensor:
    """(T, K, minitiles_per_tile) bool: the CAT evaluated only on compacted
    per-tile list entries, each against the Mt mini-tiles of its own tile.
    Memory is O(T·K·Mt). Spill-pass agnostic: the CTU calls it once per
    compacted pass."""
    device = lists.device
    if tile_origins is None:
        tile_origins = grid.tile_origins(device)
    t_origins = tile_origins.to(torch.float32)                 # (T, 2)
    top, bot = leader_corners(grid, device)
    p_top = t_origins[:, None, :] + top                        # (T, Mt, 2)
    p_bot = t_origins[:, None, :] + bot

    idx = lists.clamp_min(0).long()
    mu = proj.mean2d[idx]                                      # (T, K, 2)
    conic = proj.conic[idx]                                    # (T, K, 3)
    lhs = torch.log(255.0 * torch.clamp_min(proj.opacity, 1e-12))[idx]
    live = valid & proj.in_frustum[idx]                        # (T, K)
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)[idx]

    E = pr_gaussian_weight(mu[:, :, None, :], conic[:, :, None, :],
                           p_top[:, None, :, :], p_bot[:, None, :, :], prec)
    ok = lhs[:, :, None, None] > E * (1.0 - prec.slack)        # (T,K,Mt,4)
    ok = ok & live[:, :, None, None]
    return select_mode(ok, spiky[:, :, None], mode)


def leader_pixel_count(proj: Projected, grid: TileGrid, mode: SamplingMode,
                       spiky_threshold: float = 3.0) -> torch.Tensor:
    """Leader-pixel tests per (minitile, gaussian) implied by a mode,
    averaged over Gaussians in frustum (dense 4, sparse 2, adaptive mixes)."""
    spiky = classify_spiky(proj.axis_ratio, spiky_threshold)
    nf = torch.clamp_min(proj.in_frustum.sum(), 1)
    frac_spiky = (spiky & proj.in_frustum).sum() / nf
    device = proj.depth.device
    if mode == SamplingMode.UNIFORM_DENSE:
        return torch.tensor(4.0, device=device)
    if mode == SamplingMode.UNIFORM_SPARSE:
        return torch.tensor(2.0, device=device)
    if mode == SamplingMode.SMOOTH_FOCUSED:
        return 4.0 * (1 - frac_spiky) + 2.0 * frac_spiky
    if mode == SamplingMode.SPIKY_FOCUSED:
        return 2.0 * (1 - frac_spiky) + 4.0 * frac_spiky
    raise ValueError(mode)
