"""Pinhole camera model for the 3DGS pipeline."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    R_wc: torch.Tensor    # (3, 3) world->camera rotation
    t_wc: torch.Tensor    # (3,)   world->camera translation
    fx: torch.Tensor      # () float32 focal (px)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    near: float = 0.2

    @property
    def tan_half_fov_x(self):
        return self.width / (2.0 * self.fx)

    @property
    def tan_half_fov_y(self):
        return self.height / (2.0 * self.fy)

    def to(self, device) -> "Camera":
        """The same camera with every tensor field on `device`."""
        return dataclasses.replace(
            self, R_wc=self.R_wc.to(device), t_wc=self.t_wc.to(device),
            fx=self.fx.to(device), fy=self.fy.to(device),
            cx=self.cx.to(device), cy=self.cy.to(device))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def default_camera(width: int = 128, height: int = 128,
                   fov_deg: float = 60.0, *, device="cpu") -> Camera:
    f = width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
    return Camera(
        R_wc=torch.eye(3, dtype=torch.float32, device=device),
        t_wc=torch.zeros(3, dtype=torch.float32, device=device),
        fx=_f32(f, device), fy=_f32(f, device),
        cx=_f32(width / 2.0, device), cy=_f32(height / 2.0, device),
        width=width, height=height,
    )


def resize_camera(camera: Camera, width: int, height: int) -> Camera:
    """The same pose and field of view at a different pixel resolution:
    intrinsics scale with the pixel grid, so the visible set is unchanged."""
    if (width, height) == (camera.width, camera.height):
        return camera
    sx = width / camera.width
    sy = height / camera.height
    return dataclasses.replace(
        camera,
        fx=camera.fx * sx, cx=camera.cx * sx,
        fy=camera.fy * sy, cy=camera.cy * sy,
        width=width, height=height)


def orbit_camera(theta: float, width: int = 128, height: int = 128,
                 radius: float = 4.0, center=(0.0, 0.0, 4.0),
                 fov_deg: float = 60.0, *, device="cpu") -> Camera:
    """Camera on a circle of `radius` around `center`, looking at it."""
    cx, cy, cz = center
    pos = np.array([cx + radius * np.sin(theta), cy,
                    cz - radius * np.cos(theta)], np.float32)
    fwd = np.array(center, np.float32) - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd])               # rows: world->camera
    t = -R @ pos
    base = default_camera(width, height, fov_deg, device=device)
    return dataclasses.replace(
        base, R_wc=torch.as_tensor(R, dtype=torch.float32, device=device),
        t_wc=torch.as_tensor(t, dtype=torch.float32, device=device))
