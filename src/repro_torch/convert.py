"""Carry the reference's data across: numpy arrays in, the port's types out.

Each function takes a mapping from field name to array (for instance
`{f: np.asarray(getattr(obj, f)) for f in fields}` of a reference object)
and returns the port's type with its tensors on `device`.
`train_state_to_numpy` goes the other way, for a training state.

For the LM, `lm_params_from_numpy` takes the reference's nested parameter
tree (numpy arrays, key for key) and returns a `state_dict` for
`models.Model.load_state_dict`; `lm_params_to_numpy` goes the other way;
`lm_caches_from_numpy` carries any family's decode caches (KV, int8 KV
with scales, MLA latents, SSM states, enc-dec outputs);
`lm_opt_state_from_numpy` / `lm_opt_state_to_numpy` an optimizer state
(`optim.adamw.OptState`, `optim.adafactor.AdafactorState`) and
`lm_batch_from_numpy` a training batch.
bfloat16 arrays (numpy's `ml_dtypes` bfloat16) cross bit for bit; going
back, a bf16 tensor becomes a float32 array of the same values (exact).
Over a mesh: a `Model` on a mesh places the state_dict it loads, and the
`*_to_numpy` functions gather `distributed.sharding.Sharded` leaves; an
optimizer state from numpy is placed by `distributed.fault.
elastic_reshard` with `launch.steps.opt_shardings`' specs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene, Projected
from repro_torch.core.training import TrainState
from repro_torch.distributed.sharding import Sharded
from repro_torch.lod.build import LODScene
from repro_torch.models.pspec import tree_map


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


def _np(t) -> np.ndarray:
    if isinstance(t, Sharded):
        t = t.gather()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(model) -> dict:
    """A `Model`'s parameters as the reference's nested tree of numpy
    arrays (the inverse of `lm_params_from_numpy`; bf16 parameters as
    float32 arrays of the same values)."""
    out: dict = {}
    for k, t in model.state_dict().items():
        node = out
        *parents, last = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = _np(t)
    return out


def _field(x, name: str):
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def lm_opt_state_from_numpy(d, device="cpu"):
    """The reference's optimizer state -> the port's. `d` is an `OptState`
    (fields "m", "v": params-shaped trees, "step") or an `AdafactorState`
    ("v": a params-shaped tree of `FactoredMoment`s, each with "row",
    "col" and "full"; "step"), as the NamedTuple or a mapping of its
    fields, with numpy leaves."""
    from repro_torch.optim import adafactor, adamw

    step = _t(np.asarray(_field(d, "step"), dtype=np.int32), device)
    v = _field(d, "v")
    if (isinstance(d, Mapping) and "m" in d) or hasattr(d, "m"):
        return adamw.OptState(
            m=tree_map(lambda x: _t(x, device), _field(d, "m")),
            v=tree_map(lambda x: _t(x, device), v), step=step)

    def moment(x):
        if isinstance(x, Mapping) and "row" not in x:
            return {k: moment(y) for k, y in x.items()}
        return adafactor.FactoredMoment(
            *(_t(_field(x, f), device) for f in
              adafactor.FactoredMoment._fields))
    return adafactor.AdafactorState(v=moment(v), step=step)


def lm_opt_state_to_numpy(state) -> dict:
    """The inverse of `lm_opt_state_from_numpy`: a mapping of the state's
    fields, each moment tree nested as the params (a `FactoredMoment` as
    a mapping of "row", "col", "full")."""
    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "_fields"):
            return {f: conv(getattr(x, f)) for f in x._fields}
        return _np(x)
    return conv(state)


def lm_batch_from_numpy(d: Mapping, device="cpu") -> dict:
    """A training batch: "tokens" and "labels" as int64 tensors,
    "embeds" and "enc_embeds" as bf16 (the reference's dtype; float32
    arrays of bf16 values cross exactly)."""
    out = {}
    for k, v in d.items():
        t = _t(v, device)
        out[k] = t.long() if k in ("tokens", "labels") else \
            t.to(torch.bfloat16)
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
