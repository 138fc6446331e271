"""The benchmark's inputs, made from `--seed`: the scene and the orbit poses.

These are frozen copies of the arithmetic of the port's `random_scene` and
`orbit_camera`, so that a later change to the port's generators cannot move
the yardstick. They return plain tensors; the harness hands them to the
port through its public constructors and to the reference as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def draw_scene(generator: torch.Generator, n: int, *, extent: float,
               scale_range, spiky_frac: float, stretch: float,
               opacity_range) -> dict:
    """n Gaussians drawn on the generator's device in six calls: means in a
    slab in front of the orbit's centre, log-scales with `spiky_frac` of
    them stretched along x, random rotations, opacity logits, colours."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) \
            * (hi - lo) + lo

    means = uniform((n, 3), -extent, extent)
    means[:, 2] = means[:, 2].abs() + 2.0
    log_scales = uniform((n, 3), *scale_range)
    spiky = torch.rand((n,), generator=generator, device=dev) < spiky_frac
    log_scales[:, 0] += torch.where(spiky, math.log(stretch), 0.0)
    quats = torch.randn((n, 4), generator=generator, device=dev)
    opacity_logits = uniform((n,), *opacity_range)
    colors = torch.rand((n, 3), generator=generator, device=dev)
    return dict(means=means, log_scales=log_scales, quats=quats,
                opacity_logits=opacity_logits, colors=colors)


def scene_from_config(config: dict, seed: int, device) -> dict:
    """The configuration's scene for `seed`, drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    kw = dict(config["scene"])
    return draw_scene(gen, config["gaussians"], **kw)


def config_poses(config: dict, thetas, device) -> dict:
    """Cameras on the configuration's orbit (a circle of `radius` around
    `center`, looking at it) at its resolution, one per azimuth in
    `thetas`: R (M, 3, 3), t (M, 3) float32 on `device` (one copy each),
    and the intrinsics as float32 values."""
    orbit = config["orbit"]
    radius, center = orbit["radius"], orbit["center"]
    width, height = config["width"], config["height"]
    thetas = np.asarray(thetas, np.float64)
    cx, cy, cz = center
    pos = np.stack([cx + radius * np.sin(thetas),
                    np.full_like(thetas, cy),
                    cz - radius * np.cos(thetas)], -1).astype(np.float32)
    fwd = np.asarray(center, np.float32)[None] - pos
    fwd = fwd / np.linalg.norm(fwd, axis=-1, keepdims=True)
    up = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), fwd.shape)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right, axis=-1, keepdims=True)
    up2 = np.cross(fwd, right)
    rot = np.stack([right, up2, fwd], 1).astype(np.float32)   # (M, 3, 3)
    t = -np.einsum("mij,mj->mi", rot, pos).astype(np.float32)
    f = float(np.float32(width / (2.0 * np.tan(
        np.radians(orbit["fov_deg"]) / 2.0))))
    return dict(R=torch.from_numpy(rot).to(device),
                t=torch.from_numpy(t).to(device),
                fx=f, fy=f, cx=float(np.float32(width / 2.0)),
                cy=float(np.float32(height / 2.0)),
                width=width, height=height)


def probe_thetas(config: dict) -> list[float]:
    """The configuration's probe azimuths, evenly spaced around the orbit."""
    n = config["probe_poses"]
    return [2 * math.pi * i / n for i in range(n)]
