"""Carry the reference's data across: numpy arrays in, the port's types out.

Each function takes a mapping from field name to array (for instance
`{f: np.asarray(getattr(obj, f)) for f in fields}` of a reference object)
and returns the port's type with its tensors on `device`.
`train_state_to_numpy` goes the other way, for a training state.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene, Projected
from repro_torch.core.training import TrainState
from repro_torch.lod.build import LODScene


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


def lod_scene_from_numpy(d: Mapping, device="cpu") -> LODScene:
    """`d["scene"]` is itself a mapping of the member scene's fields;
    `n_real` an int."""
    return LODScene(
        scene=scene_from_numpy(d["scene"], device),
        **{f: _t(d[f], device) for f in ("member_cluster", "centers",
                                          "radii", "counts", "starts",
                                          "mass")},
        n_real=int(d["n_real"]))


def _scene_to_numpy(scene: GaussianScene) -> dict:
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(GaussianScene)}


def train_state_from_numpy(d: Mapping, device="cpu") -> TrainState:
    """`d` has the reference TrainState's fields: "scene", "m" and "v"
    mappings of a scene's fields, and the () int32 "step"."""
    return TrainState(
        scene=scene_from_numpy(d["scene"], device),
        m=scene_from_numpy(d["m"], device),
        v=scene_from_numpy(d["v"], device),
        step=_t(np.asarray(d["step"], dtype=np.int32), device))


def train_state_to_numpy(state: TrainState) -> dict:
    """The inverse of `train_state_from_numpy`."""
    return dict(scene=_scene_to_numpy(state.scene),
                m=_scene_to_numpy(state.m), v=_scene_to_numpy(state.v),
                step=state.step.detach().cpu().numpy())
