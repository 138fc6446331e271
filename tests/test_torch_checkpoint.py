"""The port's checkpointing (`repro_torch.checkpoint.ckpt`) and its
`FaultConfig`/`FaultManager` against the JAX reference's.

Covered: `test_substrate.py`'s round trip, atomicity (a leftover `.tmp` is
never a step) and `prune_old`; the leaf order of `jax.tree.flatten`; a
TrainState checkpoint written by either package restored by the other, bit
for bit; `restore` placing leaves on the device and dtype of `tree_like`;
`FaultManager`'s `maybe_save`/`restore_latest` and its SIGTERM flag (the
handler is called directly, never raised under xdist); and a `fit`
interrupted at step 3 and resumed, bit-equal to the uninterrupted 6 steps.
"""
import dataclasses
import json
import os
import threading
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.training as jtraining
from repro.checkpoint import ckpt as jckpt
from repro.core import random_scene as jrandom_scene
from repro.distributed.fault import (FaultConfig as JFaultConfig,
                                     FaultManager as JFaultManager)

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import (FULL_FP32, GridConfig, RenderPlan,
                              StreamConfig, TestConfig, default_camera)
from repro_torch.core import training
from repro_torch.distributed import FaultConfig, FaultManager

SIZE = 32


def fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def ref_state(seed=4, n=60, step=9):
    """A reference TrainState with nonzero moments and step."""
    scene = jrandom_scene(jax.random.PRNGKey(seed), n)
    m = jax.tree.map(lambda x: 0.01 * x, scene)
    v = jax.tree.map(lambda x: 1e-4 * x * x, scene)
    return jtraining.TrainState(scene, m, v, jnp.asarray(step, jnp.int32))


def ref_state_numpy(js) -> dict:
    return dict(scene=fields(js.scene), m=fields(js.m), v=fields(js.v),
                step=np.asarray(js.step))


def test_ckpt_roundtrip_and_atomicity(tmp_path):
    """`test_substrate.py`'s round trip and atomicity on the port."""
    tree = dict(a=torch.arange(12, dtype=torch.float32).reshape(3, 4),
                b=[torch.ones(2), torch.zeros((), dtype=torch.int32)])
    d = str(tmp_path / "ck")
    path = ckpt.save(d, 7, tree)
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f) == dict(step=7, num_leaves=3,
                                    shapes=[[3, 4], [2], []],
                                    dtypes=["float32", "float32", "int32"])
    assert ckpt.latest_step(d) == 7
    like = dict(a=torch.zeros(3, 4), b=[torch.zeros(2),
                                        torch.ones((), dtype=torch.int32)])
    back = ckpt.restore(d, 7, like)
    assert list(back) == ["a", "b"] and isinstance(back["b"], list)
    for x, y in zip(ckpt.flatten(tree), ckpt.flatten(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # A leftover .tmp is never a step.
    os.makedirs(os.path.join(d, "step_00000009.tmp"), exist_ok=True)
    assert ckpt.latest_step(d) == 7
    # Saving over an interrupted save of the same step replaces it.
    os.makedirs(os.path.join(d, "step_00000008.tmp", "junk"))
    ckpt.save(d, 8, tree)
    assert not os.path.exists(os.path.join(d, "step_00000008.tmp"))
    assert ckpt.latest_step(d) == 8
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_prune_old_keeps_newest(tmp_path):
    tree = dict(w=torch.ones(4))
    d = str(tmp_path / "ck")
    for s in (7, 8, 9, 10):
        ckpt.save(d, s, tree)
    os.makedirs(os.path.join(d, "step_00000003.tmp"))
    ckpt.prune_old(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003.tmp", "step_00000009",
                                     "step_00000010"]
    assert ckpt.latest_step(d) == 10
    ckpt.prune_old(str(tmp_path / "missing"))        # no directory: no-op


class Pair(NamedTuple):
    first: object
    second: object


def test_flatten_order_matches_jax():
    """Leaves in `jax.tree.flatten`'s order: dataclass fields in
    declaration order, NamedTuple fields, list/tuple items, dict values by
    sorted key, no leaf for None; `unflatten` rebuilds the structure."""
    def tree(leaf):
        return dict(z=Pair(leaf(1), [leaf(2), None, (leaf(3),)]),
                    a=leaf(4), m={"y": leaf(5), "b": leaf(6)})

    want = [int(x) for x in jax.tree.flatten(tree(jnp.asarray))[0]]
    assert [int(x) for x in ckpt.flatten(tree(torch.tensor))] == want
    js = ref_state()
    state = convert.train_state_from_numpy(ref_state_numpy(js))
    jleaves = jax.tree.flatten(js)[0]
    leaves = ckpt.flatten(state)
    assert len(leaves) == len(jleaves) == 16
    for x, y in zip(leaves, jleaves):
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(y))
    rebuilt = ckpt.unflatten(state, [x + 0 for x in leaves])
    assert isinstance(rebuilt, training.TrainState)
    assert isinstance(rebuilt.scene, training.GaussianScene)
    with pytest.raises(ValueError, match="more leaves"):
        ckpt.unflatten(state, leaves + [leaves[0]])


def test_port_checkpoint_restores_in_reference(tmp_path):
    js = ref_state()
    state = convert.train_state_from_numpy(ref_state_numpy(js))
    d = str(tmp_path / "ck")
    ckpt.save(d, 9, state)
    back = jckpt.restore(d, 9, jtraining.init_state(js.scene))
    assert isinstance(back, jtraining.TrainState)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_reference_checkpoint_restores_in_port(tmp_path):
    js = ref_state(seed=5, step=3)
    d = str(tmp_path / "ck")
    jckpt.save(d, 3, js)
    assert ckpt.latest_step(d) == 3
    like = training.init_state(convert.scene_from_numpy(fields(js.scene)))
    back = ckpt.restore(d, 3, like)
    assert isinstance(back, training.TrainState)
    assert back.step.dtype == torch.int32 and int(back.step) == 3
    want = ref_state_numpy(js)
    got = convert.train_state_to_numpy(back)
    for part in ("scene", "m", "v"):
        for name, w in want[part].items():
            assert got[part][name].dtype == w.dtype
            assert got[part][name].tobytes() == w.tobytes(), (part, name)


def test_restore_places_leaves_like_tree(tmp_path):
    """Each restored leaf takes the device and dtype of its `tree_like`
    leaf (a numpy leaf stays numpy); a structure or shape mismatch is
    refused."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, dict(a=torch.arange(4, dtype=torch.float32),
                         b=np.arange(3, dtype=np.int32)))
    back = ckpt.restore(d, 1, dict(a=torch.zeros(4, dtype=torch.float64),
                                   b=np.zeros(3, np.int32)))
    assert back["a"].dtype == torch.float64
    assert torch.equal(back["a"], torch.arange(4, dtype=torch.float64))
    assert isinstance(back["b"], np.ndarray)
    np.testing.assert_array_equal(back["b"], np.arange(3))
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(d, 1, dict(a=torch.zeros(4)))
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.restore(d, 1, dict(a=torch.zeros(5), b=np.zeros(3)))


def test_fault_manager_restore_and_sigterm(tmp_path):
    """`test_substrate.py`'s FaultManager case on the port, its preemption
    flag (the SIGTERM handler called directly), the hook swallowed off the
    main thread, and the same decisions as the reference's manager."""
    cfg = dict(ckpt_dir=str(tmp_path / "fm"), save_every=2,
               install_sigterm_hook=False)
    fm, jfm = FaultManager(FaultConfig(**cfg)), JFaultManager(
        JFaultConfig(**dict(cfg, ckpt_dir=str(tmp_path / "jfm"))))
    assert dataclasses.asdict(FaultConfig(ckpt_dir="x")) == \
        dataclasses.asdict(JFaultConfig(ckpt_dir="x"))
    tree = dict(w=torch.ones(4))
    for m, t in ((fm, tree), (jfm, dict(w=jnp.ones(4)))):
        assert m.maybe_save(1, t) is None
        assert m.maybe_save(2, t) is not None
    tree2, step = fm.restore_latest(dict(w=torch.zeros(4)))
    assert step == 2
    assert torch.equal(tree2["w"], torch.ones(4))
    empty = FaultManager(FaultConfig(**dict(cfg,
                                            ckpt_dir=str(tmp_path / "e"))))
    like = dict(w=torch.zeros(4))
    tree3, step = empty.restore_latest(like)
    assert tree3 is like and step == 0

    for m in (fm, jfm):
        assert not m.preempted
        m._on_sigterm(15, None)
        assert m.preempted
    assert fm.maybe_save(3, tree) is not None          # preempted: any step
    assert jfm.maybe_save(3, dict(w=jnp.ones(4))) is not None
    assert sorted(os.listdir(fm.cfg.ckpt_dir)) == sorted(
        os.listdir(jfm.cfg.ckpt_dir)) == ["step_00000002", "step_00000003"]

    errors = []

    def make():
        try:
            FaultManager(FaultConfig(**dict(cfg, install_sigterm_hook=True)))
        except Exception as e:                 # pragma: no cover
            errors.append(e)

    worker = threading.Thread(target=make)
    worker.start()
    worker.join()
    assert not errors


def test_fit_resumed_from_checkpoint_is_bit_equal(tmp_path):
    """`fit` with a FaultManager, interrupted after step 3 and resumed from
    its checkpoint for steps 4-6, equals the uninterrupted 6-step fit bit
    for bit: scene, moments, step and the losses of steps 4-6."""
    scene = convert.scene_from_numpy(fields(jrandom_scene(
        jax.random.PRNGKey(3), 120, scale_range=(-2.9, -2.2))))
    cam = default_camera(SIZE, SIZE)
    target = torch.full((SIZE, SIZE, 3), 0.5)
    plan = RenderPlan(grid=GridConfig(SIZE, SIZE),
                      test=TestConfig(precision=FULL_FP32),
                      stream=StreamConfig(k_max=120))

    def manager(name):
        return FaultManager(FaultConfig(ckpt_dir=str(tmp_path / name),
                                        save_every=3,
                                        install_sigterm_hook=False))

    full = manager("full")
    want, want_losses = training.fit(scene, cam, target, plan, steps=6,
                                     fault=full)
    assert sorted(os.listdir(full.cfg.ckpt_dir)) == ["step_00000003",
                                                     "step_00000006"]
    resumed = manager("resumed")
    _, first = training.fit(scene, cam, target, plan, steps=3,
                            fault=resumed)
    assert torch.equal(first, want_losses[:3])
    got, losses = training.fit(scene, cam, target, plan, steps=6,
                               fault=resumed)
    assert losses.shape == (3,) and torch.equal(losses, want_losses[3:])
    for name in training.SCENE_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    like = training.init_state(scene)
    a = ckpt.restore(full.cfg.ckpt_dir, 6, like)
    b = ckpt.restore(resumed.cfg.ckpt_dir, 6, like)
    for x, y in zip(ckpt.flatten(a), ckpt.flatten(b)):
        assert torch.equal(x, y)
    assert int(a.step) == 6
