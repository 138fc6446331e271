"""3D Gaussian scene representation and projection (EWA splatting).

A scene holds tensors over N Gaussians:
  means      (N, 3)  float32   world-space centers
  log_scales (N, 3)  float32   log of per-axis std-devs
  quats      (N, 4)  float32   unnormalized rotation quaternions (w, x, y, z)
  opacity_logits (N,) float32  sigmoid -> opacity in [0, 1]
  colors     (N, 3)  float32   RGB in [0, 1]

Projection follows Kerbl et al.: Sigma3D = R S S^T R^T, projected to the
image plane with the EWA Jacobian, +0.3 px low-pass on the diagonal, conic =
inverse 2D covariance.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# Blend threshold shared by the rasterizer, the kernels and the projection
# cull: alpha < ALPHA_MIN is skipped at blend time, so opacity below it is
# exactly invisible.
ALPHA_MIN = 1.0 / 255.0


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    means: torch.Tensor           # (N, 3)
    log_scales: torch.Tensor      # (N, 3)
    quats: torch.Tensor           # (N, 4)
    opacity_logits: torch.Tensor  # (N,)
    colors: torch.Tensor          # (N, 3)

    @property
    def n(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "GaussianScene":
        return GaussianScene(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


class Projected(NamedTuple):
    """Per-Gaussian 2D (image-plane) features after preprocessing."""
    mean2d: torch.Tensor     # (N, 2) pixel coords
    conic: torch.Tensor      # (N, 3) inverse covariance entries (a, b, c)
    cov2d: torch.Tensor      # (N, 3) covariance entries (sxx, sxy, syy)
    depth: torch.Tensor      # (N,) camera-space z
    radius: torch.Tensor     # (N,) 3-sigma screen radius in pixels
    opacity: torch.Tensor    # (N,)
    color: torch.Tensor      # (N, 3)
    axis_ratio: torch.Tensor  # (N,) major/minor sigma ratio (>= 1)
    in_frustum: torch.Tensor  # (N,) bool
    eigvecs: torch.Tensor    # (N, 2, 2) eigenvectors of cov2d (columns)
    eigvals: torch.Tensor    # (N, 2) eigenvalues of cov2d (descending)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [torch.stack([r00, r01, r02], -1),
         torch.stack([r10, r11, r12], -1),
         torch.stack([r20, r21, r22], -1)], dim=-2)


def covariance_3d(log_scales: torch.Tensor, quats: torch.Tensor):
    """Sigma = R S S^T R^T, (..., 3, 3)."""
    R = quat_to_rotmat(quats)
    S = torch.exp(log_scales)
    RS = R * S[..., None, :]
    return RS @ RS.transpose(-1, -2)


def _sym2x2_eig(sxx, sxy, syy):
    """Closed-form eigendecomposition of a symmetric 2x2 matrix.

    Returns (eigvals (..., 2) descending, eigvecs (..., 2, 2) columns). The
    major eigenvector uses (l1-c, b) when sxx >= syy and (b, l1-a)
    otherwise, so its large component never comes from a cancellation.
    """
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4.0 - det, 0.0))
    l1 = tr / 2.0 + disc  # major
    l2 = tr / 2.0 - disc  # minor
    use_x = sxx >= syy
    v1x = torch.where(use_x, l1 - syy, sxy)
    v1y = torch.where(use_x, sxy, l1 - sxx)
    # Pre-scale by the max component so the squared norm cannot underflow;
    # fully degenerate (isotropic) matrices get an axis-aligned basis.
    m = torch.maximum(v1x.abs(), v1y.abs())
    degen = m < 1e-30
    safe = torch.where(degen, torch.ones_like(m), m)
    v1x = torch.where(degen, torch.ones_like(v1x), v1x / safe)
    v1y = torch.where(degen, torch.zeros_like(v1y), v1y / safe)
    n1 = torch.sqrt(v1x * v1x + v1y * v1y)
    v1x, v1y = v1x / n1, v1y / n1
    v2x, v2y = -v1y, v1x
    vals = torch.stack([l1, l2], dim=-1)
    vecs = torch.stack(
        [torch.stack([v1x, v2x], -1), torch.stack([v1y, v2y], -1)], dim=-2)
    return vals, vecs


def project(scene: GaussianScene, camera) -> Projected:
    """Preprocessing: 3D -> 2D features + frustum cull flags.

    Culls behind-camera, off-screen, and opacity below the 1/255 blend
    threshold (exactly invisible, so `pad_scene` padding stays inert)."""
    means = scene.means
    t = (camera.R_wc @ means.T).T + camera.t_wc  # (N, 3)
    z = t[:, 2]
    in_front = z > camera.near

    zs = torch.clamp_min(z, camera.near)
    x_ndc = t[:, 0] / zs
    y_ndc = t[:, 1] / zs
    px = x_ndc * camera.fx + camera.cx
    py = y_ndc * camera.fy + camera.cy
    mean2d = torch.stack([px, py], dim=-1)

    # EWA: J (2x3) Jacobian of projection; ndc clamped to bound it.
    lim_x = 1.3 * camera.tan_half_fov_x
    lim_y = 1.3 * camera.tan_half_fov_y
    tx = torch.clamp(x_ndc, -lim_x, lim_x) * zs
    ty = torch.clamp(y_ndc, -lim_y, lim_y) * zs
    J = torch.zeros((means.shape[0], 2, 3), dtype=means.dtype,
                    device=means.device)
    J[:, 0, 0] = camera.fx / zs
    J[:, 0, 2] = -camera.fx * tx / (zs * zs)
    J[:, 1, 1] = camera.fy / zs
    J[:, 1, 2] = -camera.fy * ty / (zs * zs)

    sigma3d = covariance_3d(scene.log_scales, scene.quats)  # (N, 3, 3)
    JW = J @ camera.R_wc                                     # (N, 2, 3)
    cov2d_m = JW @ sigma3d @ JW.transpose(-1, -2)            # (N, 2, 2)
    sxx = cov2d_m[:, 0, 0] + 0.3
    syy = cov2d_m[:, 1, 1] + 0.3
    sxy = cov2d_m[:, 0, 1]

    det = torch.clamp_min(sxx * syy - sxy * sxy, 1e-12)
    inv_det = 1.0 / det
    conic = torch.stack([syy * inv_det, -sxy * inv_det, sxx * inv_det], -1)

    eigvals, eigvecs = _sym2x2_eig(sxx, sxy, syy)
    sigma_major = torch.sqrt(torch.clamp_min(eigvals[:, 0], 1e-12))
    sigma_minor = torch.sqrt(torch.clamp_min(eigvals[:, 1], 1e-12))
    radius = torch.ceil(3.0 * sigma_major)
    axis_ratio = sigma_major / torch.clamp_min(sigma_minor, 1e-12)

    on_screen = (
        (px + radius > 0) & (px - radius < camera.width)
        & (py + radius > 0) & (py - radius < camera.height))
    opacity = torch.sigmoid(scene.opacity_logits)
    in_frustum = in_front & on_screen & (opacity >= ALPHA_MIN)

    return Projected(
        mean2d=mean2d, conic=conic,
        cov2d=torch.stack([sxx, sxy, syy], dim=-1),
        depth=z, radius=radius, opacity=opacity, color=scene.colors,
        axis_ratio=axis_ratio, in_frustum=in_frustum,
        eigvecs=eigvecs, eigvals=eigvals,
    )


def classify_spiky(axis_ratio: torch.Tensor, threshold: float = 3.0):
    """Paper §III-A: Smooth (ratio < 3) vs Spiky (ratio >= 3). True = spiky."""
    return axis_ratio >= threshold


def pad_scene(scene: GaussianScene, n_target: int) -> GaussianScene:
    """Pad a scene to `n_target` Gaussians with inert entries (opacity logit
    -30, below ALPHA_MIN, so `project` culls them for every camera)."""
    n = scene.n
    if n_target < n:
        raise ValueError(f"n_target {n_target} < scene size {n}")
    if n_target == n:
        return scene
    pad = n_target - n

    def ext(x, fill):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    unit = torch.tensor([1.0, 0, 0, 0], dtype=scene.quats.dtype,
                        device=scene.quats.device)
    return GaussianScene(
        means=ext(scene.means, 0.0),
        log_scales=ext(scene.log_scales, -10.0),
        quats=torch.cat([scene.quats, unit.expand(pad, 4)]),
        opacity_logits=ext(scene.opacity_logits, -30.0),
        colors=ext(scene.colors, 0.0),
    )


def random_scene(generator: torch.Generator, n: int, *, extent: float = 4.0,
                 scale_range=(-4.5, -1.0), spiky_frac: float = 0.4,
                 stretch: float = 6.0, opacity_range=(-2.0, 3.0),
                 device=None) -> GaussianScene:
    """Synthetic scene: means in a slab in front of the default camera,
    anisotropic scales with about `spiky_frac` of Gaussians stretched past
    axis ratio 3. Drawn from `generator` on its own device, then moved to
    `device` (default: the generator's)."""
    g = generator
    gdev = g.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=gdev) * (hi - lo) + lo

    means = uniform((n, 3), -extent, extent)
    means[:, 2] = means[:, 2].abs() + 2.0          # in front of the camera
    base = uniform((n, 3), *scale_range)
    spiky = torch.rand((n,), generator=g, device=gdev) < spiky_frac
    base[:, 0] += torch.where(spiky, float(torch.log(torch.tensor(stretch))),
                              0.0)
    quats = torch.randn((n, 4), generator=g, device=gdev)
    opacity_logits = uniform((n,), *opacity_range)
    colors = torch.rand((n, 3), generator=g, device=gdev)
    scene = GaussianScene(means, base, quats, opacity_logits, colors)
    return scene if device is None else scene.to(device)
