"""Carry the reference's data across: numpy arrays in, the port's types out.

Each function takes a mapping from field name to array (for instance
`{f: np.asarray(getattr(obj, f)) for f in fields}` of a reference object)
and returns the port's type with its tensors on `device`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene, Projected


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def scene_from_numpy(d: Mapping, device="cpu") -> GaussianScene:
    return GaussianScene(*(_t(d[f.name], device)
                           for f in dataclasses.fields(GaussianScene)))


def camera_from_numpy(d: Mapping, device="cpu") -> Camera:
    return Camera(R_wc=_t(d["R_wc"], device), t_wc=_t(d["t_wc"], device),
                  fx=_t(d["fx"], device), fy=_t(d["fy"], device),
                  cx=_t(d["cx"], device), cy=_t(d["cy"], device),
                  width=int(d["width"]), height=int(d["height"]),
                  near=float(d.get("near", 0.2)))


def projected_from_numpy(d: Mapping, device="cpu") -> Projected:
    return Projected(*(_t(d[f], device) for f in Projected._fields))
