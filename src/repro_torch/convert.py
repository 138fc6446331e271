"""Carry the reference's data across: numpy arrays in, the port's types out.

Each function takes a mapping from field name to array (for instance
`{f: np.asarray(getattr(obj, f)) for f in fields}` of a reference object)
and returns the port's type with its tensors on `device`.
`train_state_to_numpy` goes the other way, for a training state.

For the LM, `lm_params_from_numpy` takes the reference's nested parameter
tree (numpy arrays, key for key) and returns a `state_dict` for
`models.Model.load_state_dict`; `lm_params_to_numpy` goes the other way;
`lm_caches_from_numpy` carries any family's decode caches (KV, int8 KV
with scales, MLA latents, SSM states, enc-dec outputs).
bfloat16 arrays (numpy's `ml_dtypes` bfloat16) cross bit for bit.
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
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


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


def _flat(tree: Mapping, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_params_from_numpy(tree: Mapping, device="cpu") -> dict:
    """The reference's nested LM params -> a `Model` state_dict (keys are
    the tree paths joined by ".")."""
    return {k: _t(v, device) for k, v in _flat(tree)}


def lm_params_to_numpy(model) -> dict:
    """A `Model`'s parameters as the reference's nested tree of numpy
    arrays (float32 parameters; the inverse of `lm_params_from_numpy`)."""
    out: dict = {}
    for k, t in model.state_dict().items():
        node = out
        *parents, last = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t.detach().cpu().numpy()
    return out


def lm_caches_from_numpy(caches: Mapping, device="cpu") -> dict:
    """The reference's decode caches (`Model.init_caches` / `prefill` /
    `decode_step`'s, any family) -> the port's: the same nesting (dicts,
    and tuples for the pairs), arrays as tensors, `pos` as an int."""
    def conv(k, x):
        if isinstance(x, Mapping):
            return {kk: conv(kk, v) for kk, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(None, v) for v in x)
        return int(np.asarray(x)) if k == "pos" else _t(x, device)
    return conv(None, caches)
