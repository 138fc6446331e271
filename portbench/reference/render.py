"""Plain 3D Gaussian splatting in float32: the reference that decides
`correct`, and the counter of the work a frame needs.

It imports torch and nothing of the program under test. From a scene (means,
log-scales, quaternions, opacity logits, colours) and a pinhole camera it
works out, again and on its own:

  projection   EWA splatting (Kerbl et al.): Sigma = R S S^T R^T, the
               Jacobian of the perspective at the clamped (1.3 x the half
               field of view) image-plane point, +0.3 px on the diagonal,
               conic = the inverse 2D covariance, a 3-sigma screen radius
               ceil(3 sqrt(lambda_max)); culled behind the near plane, off
               screen, or at an opacity below 1/255;
  tiles        16-px tiles; a Gaussian belongs to every tile its square
               [mean - r, mean + r] overlaps (strict inequalities);
  depth order  front to back by camera-space depth, ties by index;
  mini-tiles   FLICKER's contribution-aware test (paper sec. III-IV, Alg. 1),
               when the configuration states one (`Cat`): a 4x4 mini-tile
               takes a Gaussian iff its 8x8 sub-tile overlaps the Gaussian's
               square and ln(255 o) > E (1 - slack) at one of its leader
               pixels, the corners of its pixel rectangle (dense: all
               four; sparse: the main diagonal's two; SMOOTH_FOCUSED: sparse
               for a Gaussian with axis ratio 3 or more), E evaluated with
               one rounding per step in the stated precisions (fp16 by
               round trip, fp8 e4m3 with |x| > 464 becoming NaN, which
               never passes);
  blending     per pixel centre, alpha = min(0.99, o exp(-E)) with
               E = 0.5 (a dx^2 + c dy^2) + b dx dy, skipped below 1/255
               and where the pixel's mini-tile did not take the Gaussian;
               a pixel blends an entry while its transmittance before the
               entry is at least 1e-4 (then it terminates);
               colour = sum of T alpha c over the blended entries, on a
               black background.

It runs in blocks of tiles and of list entries, so a Full-HD frame with a
million Gaussians fits on one card. `precision="tf32"` rounds every matmul
operand to TF32's 10-bit mantissa before a float32 product: the control
that a comparison must fail.

Work counts (`Counts`) are what these inputs need, whatever implements
them: the Gaussians projected, the (Gaussian, tile) pairs of each tile's
depth-ordered list up to the entry at which every pixel of the tile has
terminated (split into smooth and spiky Gaussians, axis ratio 3), the
entries of those with at least one blended lane, and the (pixel, Gaussian)
lanes blended.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
SPIKY_RATIO = 3.0
ENTRY_CHUNK = 256            # list entries a block blends at once
BLOCK_ELEMS = 1 << 26        # (tiles x pixels x entries) floats per block


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera as plain tensors: world->camera rotation R (3, 3)
    and translation t (3,), focal lengths and principal point in pixels."""
    R: torch.Tensor
    t: torch.Tensor
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    near: float = 0.2


@dataclasses.dataclass(frozen=True)
class Cat:
    """The mini-tile test a configuration states: sampling mode and the
    precision of each step of Alg. 1 ("fp32", "fp16" or "fp8")."""
    mode: str = "smooth_focused"
    coord: str = "fp16"
    delta: str = "fp8"
    mul: str = "fp16"
    acc: str = "fp16"
    slack: float = 0.15


@dataclasses.dataclass
class Counts:
    """The work one frame needs (see the module docstring)."""
    gaussians: int = 0
    pairs_smooth: int = 0
    pairs_spiky: int = 0
    entries_blended: int = 0
    lanes: int = 0
    pixels: int = 0

    @property
    def pairs(self) -> int:
        return self.pairs_smooth + self.pairs_spiky


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


@contextlib.contextmanager
def _no_tf32():
    """float32 matmuls in float32 on the card: TF32 off while inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


FP8_OVERFLOW = 464.0


def _quant(x: torch.Tensor, kind: str) -> torch.Tensor:
    """One rounding of x to `kind`, back in float32."""
    if kind == "fp32":
        return x
    if kind == "fp16":
        return x.half().float()
    if kind == "fp8":
        q = x.to(torch.float8_e4m3fn).float()
        return torch.where(x.abs() <= FP8_OVERFLOW, q,
                           torch.full_like(q, float("nan")))
    raise ValueError(f"unknown precision {kind!r}")


def _minitile_bits(cat: Cat, mean, conic, radius, lhs, spiky, ox, oy):
    """(L, K, 16) bool: mini-tile m of the entry's tile takes the entry.
    mean (L, K, 2), conic (L, K, 3), radius (L, K), lhs (L, K) =
    ln(255 o), spiky (L, K); ox, oy (L,) the tiles' pixel origins."""
    device = mean.device
    r = torch.arange(4, device=device, dtype=torch.float32) * 4
    lx = r.repeat(4)                    # mini-tiles row-major in the tile
    ly = r.repeat_interleave(4)
    top_x = (ox[:, None] + lx)[:, None, :] + 0.5              # (L, 1, 16)
    top_y = (oy[:, None] + ly)[:, None, :] + 0.5
    bot_x, bot_y = top_x + 3.0, top_y + 3.0
    qc, qd = (lambda x: _quant(x, cat.coord)), (lambda x: _quant(x, cat.delta))
    qm, qa = (lambda x: _quant(x, cat.mul)), (lambda x: _quant(x, cat.acc))
    mx, my = qc(mean[..., 0])[..., None], qc(mean[..., 1])[..., None]
    a, b, c = (qc(conic[..., i])[..., None] for i in range(3))
    dtx, dty = qd(qc(top_x) - mx), qd(qc(top_y) - my)         # (L, K, 16)
    dbx, dby = qd(qc(bot_x) - mx), qd(qc(bot_y) - my)

    def sep(d, w):
        return qm(qm(0.5 * qm(d * d)) * w)

    stx, sty, sbx, sby = sep(dtx, a), sep(dty, c), sep(dbx, a), sep(dby, c)
    e = torch.stack([qa(qa(stx + sty) + qm(qm(dtx * dty) * b)),
                     qa(qa(sbx + sty) + qm(qm(dbx * dty) * b)),
                     qa(qa(stx + sby) + qm(qm(dtx * dby) * b)),
                     qa(qa(sbx + sby) + qm(qm(dbx * dby) * b))], -1)
    ok = lhs[..., None, None] > e * (1.0 - cat.slack)         # (L,K,16,4)
    dense, sparse = ok.any(-1), ok[..., 0] | ok[..., 3]
    spiky = spiky[..., None]
    if cat.mode == "uniform_dense":
        bits = dense
    elif cat.mode == "uniform_sparse":
        bits = sparse
    elif cat.mode == "smooth_focused":
        bits = torch.where(spiky, sparse, dense)
    elif cat.mode == "spiky_focused":
        bits = torch.where(spiky, dense, sparse)
    else:
        raise ValueError(f"unknown sampling mode {cat.mode!r}")
    # The hierarchy's middle level: the mini-tile's 8x8 sub-tile must
    # overlap the Gaussian's square too.
    sx = (ox[:, None] + lx // 8 * 8)[:, None, :]              # (L, 1, 16)
    sy = (oy[:, None] + ly // 8 * 8)[:, None, :]
    mxf, myf, rad = mean[..., 0:1], mean[..., 1:2], radius[..., None]
    sub = (((mxf + rad) > sx) & ((mxf - rad) < sx + 8)
           & ((myf + rad) > sy) & ((myf - rad) < sy + 8))
    return bits & sub


def _rotations(quats: torch.Tensor) -> torch.Tensor:
    q = quats / (torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
                 + 1e-12)
    w, x, y, z = q.unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def project(scene: dict, cam: Camera, precision: str = "fp32") -> dict:
    """Screen-space Gaussians of the visible part of the scene, in depth
    order: mean (M, 2), conic (M, 3) as (a, b, c), radius (M,), opacity
    (M,), colour (M, 3), spiky (M,) bool; and `n`, the Gaussians
    projected. The steps keep the order of operations of Kerbl et al.'s
    formulas as written, so that two float32 implementations round alike
    where a covariance is near-degenerate."""
    means = scene["means"]
    n = means.shape[0]
    fx, fy, cx, cy = (torch.tensor(v, dtype=torch.float32,
                                   device=means.device)
                      for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    p = _mm(cam.R, means.T, precision).T + cam.t
    z = p[:, 2]
    zs = torch.clamp_min(z, cam.near)
    xn, yn = p[:, 0] / zs, p[:, 1] / zs
    px, py = xn * fx + cx, yn * fy + cy
    lim_x = 1.3 * (cam.width / (2.0 * fx))
    lim_y = 1.3 * (cam.height / (2.0 * fy))
    tx = torch.minimum(torch.maximum(xn, -lim_x), lim_x) * zs
    ty = torch.minimum(torch.maximum(yn, -lim_y), lim_y) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([
        torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1)],
        -2)                                                   # (N, 2, 3)
    m = _rotations(scene["quats"]) * torch.exp(scene["log_scales"])[:, None]
    sigma = _mm(m, m.transpose(1, 2), precision)             # (N, 3, 3)
    jw = _mm(jac, cam.R, precision)                          # (N, 2, 3)
    cov = _mm(_mm(jw, sigma, precision), jw.transpose(1, 2), precision)
    a = cov[:, 0, 0] + 0.3
    c = cov[:, 1, 1] + 0.3
    b = cov[:, 0, 1]
    det_raw = a * c - b * b
    inv_det = 1.0 / torch.clamp_min(det_raw, 1e-12)
    tr = a + c
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4.0 - det_raw, 0.0))
    s1 = torch.sqrt(torch.clamp_min(tr / 2.0 + disc, 1e-12))
    s2 = torch.sqrt(torch.clamp_min(tr / 2.0 - disc, 1e-12))
    radius = torch.ceil(3.0 * s1)
    opacity = torch.sigmoid(scene["opacity_logits"])
    visible = ((z > cam.near) & (px + radius > 0) & (px - radius < cam.width)
               & (py + radius > 0) & (py - radius < cam.height)
               & (opacity >= ALPHA_MIN))
    ids = torch.nonzero(visible).flatten()
    ids = ids[torch.argsort(z[ids], stable=True)]
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    return dict(n=n, mean=torch.stack([px, py], -1)[ids], conic=conic[ids],
                radius=radius[ids], opacity=opacity[ids],
                colour=scene["colors"][ids],
                spiky=(s1 / torch.clamp_min(s2, 1e-12) >= SPIKY_RATIO)[ids])


def tile_lists(g: dict, tiles_x: int, tiles_y: int):
    """Every tile's list of depth ranks: (ranks (P,) int64 grouped by tile
    in depth order, start (T,) and count (T,) of each tile's run)."""
    mx, my, r = g["mean"][:, 0], g["mean"][:, 1], g["radius"]
    x0 = torch.floor((mx - r) / TILE).long().clamp(0, tiles_x - 1)
    x1 = (torch.ceil((mx + r) / TILE).long() - 1).clamp(0, tiles_x - 1)
    y0 = torch.floor((my - r) / TILE).long().clamp(0, tiles_y - 1)
    y1 = (torch.ceil((my + r) / TILE).long() - 1).clamp(0, tiles_y - 1)
    w = (x1 - x0 + 1).clamp_min(0)
    span = w * (y1 - y0 + 1).clamp_min(0)
    device = mx.device
    ranks = torch.repeat_interleave(torch.arange(mx.shape[0], device=device),
                                    span)
    first = torch.cumsum(span, 0) - span
    j = torch.arange(ranks.shape[0], device=device) - first[ranks]
    tile = (y0[ranks] + j // w[ranks]) * tiles_x + x0[ranks] + j % w[ranks]
    tile, perm = torch.sort(tile, stable=True)
    count = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return ranks[perm], torch.cumsum(count, 0) - count, count


def _blend_block(g, ranks, start, count, tiles, tiles_x, precision, cat,
                 counts):
    """Blend the lists of `tiles` (B,) front to back. Returns their pixels'
    colours (B, 256, 3); adds the block's work to `counts`."""
    device = ranks.device
    b = tiles.shape[0]
    r = torch.arange(TILE, device=device, dtype=torch.float32) + 0.5
    ox = (tiles % tiles_x).float() * TILE
    oy = (tiles // tiles_x).float() * TILE
    px = (ox[:, None, None] + r[None, None, :]).expand(b, TILE, TILE)
    py = (oy[:, None, None] + r[None, :, None]).expand(b, TILE, TILE)
    px, py = px.reshape(b, -1, 1), py.reshape(b, -1, 1)       # (B, 256, 1)
    pix = torch.arange(TILE * TILE, device=device)
    minitile = (pix // TILE) // 4 * 4 + (pix % TILE) // 4     # (256,)
    lhs_all = torch.log(255.0 * torch.clamp_min(g["opacity"], 1e-12))
    trans = torch.ones((b, TILE * TILE), device=device)
    rgb = torch.zeros((b, TILE * TILE, 3), device=device)
    live = torch.arange(b, device=device)      # rows some pixel still lives
    length = int(count[tiles].max()) if b else 0
    for s in range(0, length, ENTRY_CHUNK):
        if live.numel() == 0:
            break
        k = s + torch.arange(ENTRY_CHUNK, device=device)
        valid = k[None, :] < count[tiles[live]][:, None]      # (L, K)
        idx = torch.where(valid, start[tiles[live]][:, None] + k[None, :], 0)
        gid = ranks[idx]
        mean, conic = g["mean"][gid], g["conic"][gid]
        dx = px[live] - mean[:, None, :, 0]                   # (L, 256, K)
        dy = py[live] - mean[:, None, :, 1]
        e = (0.5 * (conic[:, None, :, 0] * (dx * dx)
                    + conic[:, None, :, 2] * (dy * dy))
             + conic[:, None, :, 1] * dx * dy)
        alpha = torch.clamp_max(g["opacity"][gid][:, None, :]
                                * torch.exp(-e), ALPHA_MAX)
        lane = valid[:, None, :]
        if cat is not None:
            bits = _minitile_bits(cat, mean, conic, g["radius"][gid],
                                  lhs_all[gid], g["spiky"][gid], ox[live],
                                  oy[live])
            lane = lane & bits[:, :, minitile].transpose(1, 2)
        alpha = torch.where((alpha >= ALPHA_MIN) & lane, alpha,
                            torch.zeros_like(alpha))
        keep = torch.cumprod(1.0 - alpha, dim=2)
        t_before = trans[live][:, :, None] * torch.cat(
            [torch.ones_like(keep[:, :, :1]), keep[:, :, :-1]], dim=2)
        alive = t_before >= T_EPS
        weight = torch.where(alive, t_before * alpha,
                             torch.zeros_like(alpha))
        rgb[live] += _mm(weight, g["colour"][gid], precision)
        needed = alive.any(dim=1) & valid                      # (L, K)
        lanes = alive & (alpha > 0)
        spiky = g["spiky"][gid]
        counts.pairs_spiky += int((needed & spiky).sum())
        counts.pairs_smooth += int((needed & ~spiky).sum())
        counts.entries_blended += int(lanes.any(dim=1).sum())
        counts.lanes += int(lanes.sum())
        trans[live] = trans[live] * keep[:, :, -1]
        live = live[(trans[live] >= T_EPS).any(dim=1)]
    return rgb


def render(scene: dict, cam: Camera, cat: Cat | None, precision: str = "fp32",
           block_elems: int = BLOCK_ELEMS):
    """The frame (H, W, 3) float32 and its `Counts`. `scene` maps means,
    log_scales, quats, opacity_logits and colors to float32 tensors on one
    device; the work runs there. `cat` is the configuration's mini-tile
    test (None: plain 3DGS)."""
    if cam.width % TILE or cam.height % TILE:
        raise ValueError(f"{cam.width}x{cam.height} is not a multiple of "
                         f"{TILE}-px tiles")
    with _no_tf32():
        g = project(scene, cam, precision)
        tiles_x, tiles_y = cam.width // TILE, cam.height // TILE
        ranks, start, count = tile_lists(g, tiles_x, tiles_y)
        counts = Counts(gaussians=g["n"], pixels=cam.width * cam.height)
        device = ranks.device
        rgb = torch.zeros((tiles_x * tiles_y, TILE * TILE, 3), device=device)
        by_length = torch.argsort(count, descending=True)
        block = max(1, block_elems // (TILE * TILE * ENTRY_CHUNK))
        for s in range(0, by_length.shape[0], block):
            tiles = by_length[s:s + block]
            rgb[tiles] = _blend_block(g, ranks, start, count, tiles, tiles_x,
                                      precision, cat, counts)
    image = rgb.reshape(tiles_y, tiles_x, TILE, TILE, 3).transpose(1, 2)
    return image.reshape(cam.height, cam.width, 3), counts
