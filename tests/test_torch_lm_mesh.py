"""The port's dense LM over a mesh (`distributed.sharding`, `models.pspec`
placements, the tensor-parallel `models` path, `optim.adamw` on shards,
`launch.steps`' placements and bound steps, `launch.mesh`,
`distributed.fault.elastic_reshard`, sharded checkpoints) against the JAX
reference's sharded path on the CPU.

Meshes are repeated CPU devices: `[torch.device("cpu")] * 4` as
(data=2, model=2), 8 as (pod=2, data=2, model=2). The reference runs once,
in a subprocess started by an autouse fixture (`python
tests/test_torch_lm_mesh.py OUT.npz` writes its outputs), on 8 host
devices and meshes built with `jax.sharding.Mesh(np.array(devices)
.reshape(...), names)`: `jax.make_mesh` makes Explicit axes under this
JAX, which `with_sharding_constraint` refuses. It writes the placements of
all ten archs and, on its (2, 2) mesh with the parameters placed by its
rules, the float32 loss and gradients of `Model.loss` and one
`jit_train_step` (2 microbatches, AdamW at the full rate) for reduced
qwen1.5-0.5b (SwiGLU, tied, 4 kv heads: kv replicated), a 16-kv-head
variant of it (kv over "model") and reduced nemotron-4-15b (relu2,
untied). Weights and batches are numpy draws from a seed.

Tolerances (float32 compute; in brackets what an x86 CPU measured,
printed by `python tests/test_torch_lm_mesh.py --spreads REF.npz` after
the reference's run has written REF.npz):
  placements       equal (PartitionSpec entries, a one-axis tuple as its
                   axis, as jax's PartitionSpec compares them)
  shard/gather,    bit-equal
  elastic_reshard
  loss, grad norm  rtol 1e-5, the card's phase 13a gate [loss 1.5e-7,
                   grad norm 5.6e-7]
  gradients        each leaf within 2e-5 of its largest |g|, about three
                   times the measured [6.8e-6]
  train step       each parameter's update within 1e-3 lr plus two
                   float32 ulps where the reference's gradient exceeds
                   1e-2 of its leaf's largest (`test_torch_lm_train.py`'s
                   criterion) [1.9e-7
                   lr]; every replica bit-equal to the first
  serving          prefill logits and decode logits with float32 caches
                   rtol 1e-4, atol 1e-4 x max|logit| [1.0e-6]; with the
                   model's bf16 and int8 caches each cache element within
                   one bf16 ulp past float32 noise of 1e-5 of the leaf's
                   largest, or one int8 step, and the scales rtol 1e-5:
                   float32 sums in another order move a value across a
                   rounding boundary now and then, which moves the logits
                   [bf16 3.8e-5, int8 1.9e-5 x max|logit|]; those logits
                   are not gated
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.configs as T
from repro_torch import convert
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as D
from repro_torch.distributed.fault import (FaultConfig, FaultManager,
                                           elastic_reshard)
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import pspec
from repro_torch.models.model import Model
from repro_torch.models.parity import cache_steps, float32_caches
from repro_torch.optim import adafactor, adamw

from test_torch_lm import REF_XLA_FLAGS
from test_torch_lm_families import FAST_XLA_FLAGS
from test_torch_lm_train import ONE_THREAD_XLA_FLAGS

ALL_ARCHS = sorted(T.ARCHS)
CPU = torch.device("cpu")
# (name, extra config fields) of the loss and gradient parity.
PARITY = [("qwen1.5-0.5b", {}),
          ("qwen1.5-0.5b", dict(num_heads=16, num_kv_heads=16)),
          ("nemotron-4-15b", {})]
BATCH, SEQ = 4, 32
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def cpu_mesh(shape, names=("data", "model")) -> D.Mesh:
    flat = [CPU] * int(np.prod(shape))
    for n in reversed(shape[1:]):
        flat = [flat[i:i + n] for i in range(0, len(flat), n)]
    return D.Mesh(flat, names)


def parity_cfg(i: int, mod=T):
    name, extra = PARITY[i]
    return dataclasses.replace(mod.reduced(mod.get_arch(name)),
                               dtype="float32", attn_chunk=8, **extra)


def draw(cfg_specs, seed: int) -> dict:
    """Flat numpy weights by the reference's init rules (qkv biases
    nonzero) from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, p in pspec.leaves(cfg_specs):
        if path.endswith(("bq", "bk", "bv")):
            x = rng.normal(0, 0.5, p.shape)
        elif p.init in ("zeros", "ones"):
            x = np.full(p.shape, p.init == "ones")
        else:
            fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
            scale = 0.02 if p.init == "small" else fan_in ** -0.5
            x = rng.normal(0, 1, p.shape) * scale
        out[path] = x.astype(np.float32)
    return out


def batch_of(cfg, seed: int, b: int = BATCH) -> dict:
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    out["labels"][0, :3] = -1
    return out


def nest(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def spec_json(spec) -> list:
    """A placement's entries as JSON, a one-axis tuple as its axis (a jax
    PartitionSpec's own normalization: P(("data",)) == P("data"))."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = e[0] if len(e) == 1 else list(e)
        out.append(e)
    return out


def placements(mod, spec_of, mesh_of, model_of) -> dict:
    """Every placement the file compares, as JSON-able specs keyed by
    "arch/mesh/fsdp_over_pod/what/leaf path". `spec_of` reads a
    placement's spec, `mesh_of(key)` makes a mesh, `model_of(cfg)` a
    model."""
    out = {}
    for name in ALL_ARCHS:
        for mk in MESHES:
            mesh = mesh_of(mk)
            for fop in (False, True):
                cfg = dataclasses.replace(mod.get_arch(name),
                                          fsdp_over_pod=fop)
                model = model_of(cfg)
                trees = dict(
                    params=(mod.partition_specs(model.specs(), mesh, fop),
                            lambda s: s),
                    opt=(mod.opt_shardings(model, mesh), spec_of),
                    adafactor=(mod.adafactor_shardings(
                        model, mesh, mod.AdafactorConfig()), spec_of))
                for b in (1, 3, 4):
                    trees[f"cache{b}"] = (mod.cache_shardings(
                        model, b, 32, mesh), spec_of)
                    trees[f"batch{b}"] = (mod.batch_shardings(
                        model, ShapeConfig("t", "train", 32, b), mesh),
                        spec_of)
                for what, (tree, fn) in trees.items():
                    for path, leaf in placement_leaves(tree):
                        out[f"{name}/{mk}/{int(fop)}/{what}/{path}"] = \
                            spec_json(fn(leaf))
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or isinstance(e, tuple) for e in x)


def placement_leaves(tree, prefix=""):
    """(path, leaf) of a placement tree: dicts, NamedTuples and tuples of
    placements are nodes; a placement or a spec is a leaf."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, tuple) and not _is_spec(tree):
        items = list(enumerate(tree))
    else:
        yield prefix.rstrip("."), tree
        return
    for k, v in items:
        yield from placement_leaves(v, f"{prefix}{k}.")


# ---------------------------------------------------------------------------
# The reference (subprocess)
# ---------------------------------------------------------------------------

def write_reference(path: str) -> None:
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.configs as R
    from repro.launch import steps as JST
    from repro.models import pspec as jpspec
    from repro.models.model import Model as JModel
    from repro.optim import adafactor as jaf
    from repro.optim import adamw as jadamw

    devs = np.array(jax.devices())
    meshes = {k: Mesh(devs[:int(np.prod(s))].reshape(s), n)
              for k, (s, n) in MESHES.items()}
    jmod = types.SimpleNamespace(
        get_arch=R.get_arch, partition_specs=jpspec.partition_specs,
        opt_shardings=JST.opt_shardings,
        adafactor_shardings=JST.adafactor_shardings,
        cache_shardings=JST.cache_shardings,
        batch_shardings=JST.batch_shardings,
        AdafactorConfig=jaf.AdafactorConfig)
    out = {"placements": np.array(json.dumps(placements(
        jmod, lambda s: tuple(s.spec), meshes.get, JModel)))}

    mesh = meshes["2x2"]
    jobs = []
    for i in range(len(PARITY)):
        cfg = parity_cfg(i, R)
        model = JModel(cfg)
        flat = draw(model.specs(), 70 + i)
        shard = jpspec.shardings(model.specs(), mesh)
        params = jax.device_put(jax.tree.map(jnp.asarray, nest(flat)), shard)
        batch = {k: jnp.asarray(v) for k, v in batch_of(cfg, 80 + i).items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, model=model: model.loss(p, b, mesh)))
        jobs.append((f"loss{i}", fn, (params, batch)))

    cfg = dataclasses.replace(parity_cfg(0, R), microbatches=2)
    model = JModel(cfg)
    opt_cfg = dataclasses.replace(JST.make_opt_cfg(cfg), warmup_steps=1)
    fn, _ = JST.jit_train_step(model, opt_cfg, mesh,
                               ShapeConfig("t", "train", SEQ, BATCH))
    params = jax.tree.map(jnp.asarray, nest(draw(model.specs(), 70)))
    state = jadamw.init(params, opt_cfg)
    batch = {k: jnp.asarray(v) for k, v in batch_of(cfg, 80).items()}
    jobs.append(("step", fn, (params, state, batch)))

    for key, fn, args in jobs:
        res = fn(*args)
        if key.startswith("loss"):
            loss, grads = res
            out[f"{key}/loss"] = np.asarray(loss)
            out.update({f"{key}/grads/{k}": np.asarray(v)
                        for k, v in pspec.leaves(grads)})
        else:
            p2, s2, metrics = res
            out.update({f"step/params/{k}": np.asarray(v)
                        for k, v in pspec.leaves(p2)})
            out.update({f"step/m/{k}": np.asarray(v)
                        for k, v in pspec.leaves(s2.m)})
            out.update({f"step/{k}": np.asarray(v)
                        for k, v in metrics.items()})
    np.savez(path, **out)


def start_reference(d: pathlib.Path) -> subprocess.Popen:
    flags = (os.environ.get("XLA_FLAGS", "")
             + f" {REF_XLA_FLAGS} {FAST_XLA_FLAGS} {ONE_THREAD_XLA_FLAGS}"
             " --xla_force_host_platform_device_count=8")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip())
    with open(d / "stderr.txt", "w") as err:
        return subprocess.Popen([sys.executable, __file__,
                                 str(d / "reference.npz")],
                                stdout=subprocess.DEVNULL, stderr=err,
                                env=env)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocess with the module's first test, so
    that it runs beside the tests that do not need it."""
    d = tmp_path_factory.mktemp("lm_mesh")
    proc = start_reference(d)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield proc, d
    torch.set_num_threads(threads)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def refs(reference_run):
    proc, d = reference_run
    rc = proc.wait(timeout=600)
    assert rc == 0, (d / "stderr.txt").read_text()[-4000:]
    data = np.load(d / "reference.npz")
    return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def sharded_model(cfg, mesh, flat: dict) -> Model:
    m = Model(cfg, device="cpu", seed=0, mesh=mesh)
    m.load_state_dict(convert.lm_params_from_numpy(nest(flat)))
    return m


def grads_gathered(model: Model, batch: dict) -> tuple:
    """(loss, {path: the gradient gathered whole, replicas summed})."""
    model.requires_grad_(True)
    leaves = flatten(model.params())
    tensors = ST._tensors(leaves)
    loss, g = ST.grads_of(model, batch, tensors)
    model.requires_grad_(False)
    out = {}
    for (path, _), t in zip(pspec.leaves(model.params()),
                            ST._repack(leaves, list(g))):
        out[path] = adamw.sum_replicas(t).gather()
    return loss, out


def assert_replicas_equal(tree) -> None:
    for t in flatten(tree):
        if isinstance(t, D.Sharded):
            for grp in t.sharding.replica_groups():
                for i in grp[1:]:
                    assert torch.equal(t.pieces[i], t.pieces[grp[0]])


def tbatch(d: dict) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in d.items()}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_mesh_axes_resolve_and_collectives():
    """`Mesh` over (data, model) and (pod, data, model); `resolve`'s
    rules and refusal; `named`/`shard`/`gather` of uneven dimensions
    refused; the collectives' sums and gathers against the whole tensor;
    the render meshes keep their shape."""
    m2 = cpu_mesh((2, 2))
    assert m2.axis_names == ("data", "model") and m2.shape == {
        "data": 2, "model": 2}
    m3 = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    assert m3.shape == {"pod": 2, "data": 2, "model": 2}
    assert D.dp_axes(m3) == ("pod", "data") and D.dp_size(m3) == 4
    assert m3.rows() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert D.Mesh([CPU] * 3).shape == {"data": 1, "model": 3}
    log = ("fsdp", "model", "sp", "dp", None, "tile")
    assert D.resolve(log, m2) == ("data", "model", "model", ("data",),
                                  None, "model")
    assert D.resolve(log, m3) == ("data", "model", "model",
                                  ("pod", "data"), None, "model")
    assert D.resolve(("fsdp",), m3, fsdp_over_pod=True) == (("pod", "data"),)
    assert D.resolve(("fsdp",), m2, fsdp_over_pod=True) == ("data",)
    with pytest.raises(ValueError, match="unknown logical axis"):
        D.resolve(("expert",), m2)
    with pytest.raises(ValueError, match="cannot be sharded"):
        D.shard(torch.zeros(3, 4), D.named(m2, ("fsdp", None)))
    with pytest.raises(ValueError):
        D.Mesh([[CPU, CPU], [CPU]])
    x = torch.randn(4, 6)
    parts = list(x.chunk(2, 0))
    devs = [CPU, CPU]
    for got in D.all_gather(parts, 0, devs):
        assert torch.equal(got, x)
    for got in D.all_reduce(parts, devs):
        assert torch.equal(got, parts[0] + parts[1])
    for i, got in enumerate(D.reduce_scatter([x, 2 * x], 1, devs)):
        assert torch.equal(got, (x + 2 * x).chunk(2, 1)[i])


def test_placements_match_reference(refs):
    """`pspec.partition_specs`, `opt_shardings`, `adafactor_shardings`,
    `cache_shardings` (batch 1, 3, 4) and `batch_shardings` (train batch
    1, 3, 4) of all ten archs at full width on (2, 2) and (2, 2, 2), with
    `fsdp_over_pod` off and on: the reference's PartitionSpecs."""
    import types
    tmod = types.SimpleNamespace(
        get_arch=T.get_arch, partition_specs=pspec.partition_specs,
        opt_shardings=ST.opt_shardings,
        adafactor_shardings=ST.adafactor_shardings,
        cache_shardings=ST.cache_shardings,
        batch_shardings=ST.batch_shardings,
        AdafactorConfig=adafactor.AdafactorConfig)
    meshes = {k: cpu_mesh(s, n) for k, (s, n) in MESHES.items()}
    got = placements(tmod, lambda s: s.spec, meshes.get,
                     lambda cfg: Model(cfg, device="meta"))
    want = json.loads(str(refs["placements"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_shard_gather_and_elastic_reshard_bit_equal():
    """Every reduced qwen leaf placed on (2, 2) and gathered back; the
    parameter tree resharded (2, 2) -> (1, 4) -> (4, 1) by
    `elastic_reshard` with `partition_specs`, each gather bit-equal; a
    (2, 2, 2) placement under `fsdp_over_pod` holds each block once per
    model column; a replicated leaf is a copy at every position."""
    cfg = T.reduced(T.get_arch("qwen1.5-0.5b"))
    a = Model(cfg, device="cpu", seed=3, mesh=cpu_mesh((2, 2)))
    whole = Model(cfg, device="cpu", seed=3)
    for k, v in whole.state_dict().items():
        assert torch.equal(a.state_dict()[k], v), k
    tree = a.params()
    for shape in ((1, 4), (4, 1)):
        mesh = cpu_mesh(shape)
        tree = elastic_reshard(tree, mesh, pspec.partition_specs(
            a.specs(), mesh))
        for path, t in pspec.leaves(tree):
            assert t.sharding.mesh is mesh
            assert torch.equal(t.gather(), whole.state_dict()[path]), \
                (shape, path)
    ln = tree["ln_f"]
    assert len({p.data_ptr() for p in ln.pieces}) == len(ln.pieces)
    m3 = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    sh = D.named(m3, ("fsdp", "model"), fsdp_over_pod=True)
    x = torch.randn(8, 6)
    pieces = D.shard(x, sh)
    assert [p.shape for p in pieces] == [(2, 3)] * 8
    assert torch.equal(D.gather(pieces, sh), x)
    assert len(sh.replica_groups()) == 8
    full = D.gather_over(pieces, sh, ("pod", "data"))
    assert torch.equal(full[0], x[:, :3]) and torch.equal(full[7], x[:, 3:])


def test_production_mesh():
    """`make_production_mesh` over 256 and 512 repeated devices has the
    reference's shape and axis names; fewer devices raise ValueError with
    the counts."""
    m = LM.make_production_mesh(devices=[CPU] * 256)
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 16, "model": 16}
    m = LM.make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert m.axis_names == ("pod", "data", "model")
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 256 devices; 255"):
        LM.make_production_mesh(devices=[CPU] * 255)
    with pytest.raises(ValueError, match="needs 512 devices; 256"):
        LM.make_production_mesh(multi_pod=True, devices=[CPU] * 256)


def test_sharded_loss_and_grads_match_reference(refs):
    """float32 loss and gradients on (2, 2) against the reference's
    sharded `Model.loss`, for reduced qwen (kv replicated), the
    16-kv-head variant (kv over "model") and reduced nemotron (relu2);
    the port's (1, 4), (4, 1) and (2, 2, 2) meshes against its (2, 2)."""
    mesh = cpu_mesh((2, 2))
    for i in range(len(PARITY)):
        cfg = parity_cfg(i)
        flat = draw(Model(cfg, device="meta").specs(), 70 + i)
        batch = tbatch(batch_of(cfg, 80 + i))
        loss, grads = grads_gathered(sharded_model(cfg, mesh, flat), batch)
        want = float(refs[f"loss{i}/loss"])
        assert abs(float(loss) - want) <= 1e-5 * abs(want), PARITY[i]
        for k, g in grads.items():
            w = refs[f"loss{i}/grads/{k}"]
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=2e-5 * scale, err_msg=k)
        for shape, names in (((1, 4), None), ((4, 1), None),
                             ((2, 2, 2), ("pod", "data", "model"))):
            other = sharded_model(cfg, cpu_mesh(shape, names or
                                                ("data", "model")), flat)
            l2, g2 = grads_gathered(other, batch)
            assert abs(float(l2) - float(loss)) <= 1e-5 * abs(want)
            for k in grads:
                scale = float(grads[k].abs().max())
                assert float((g2[k] - grads[k]).abs().max()) \
                    <= 2e-5 * scale, (shape, k)


def step_update_check(m: Model, before: dict, ref_params: dict,
                      ref_m: dict, lr: float, b1: float) -> float:
    """`test_torch_lm_train.py`'s update criterion; returns the worst
    |Δ update| / lr past two ulps where the reference's gradient exceeds
    1e-2 of its leaf's."""
    worst = 0.0
    for k, after in m.state_dict().items():
        g = np.abs(ref_m[k] / (1 - b1))
        sel = g > 1e-2 * g.max()
        got = (after - before[k]).numpy()
        want = ref_params[k] - before[k].numpy()
        ulp = 2 * np.spacing(np.abs(after.numpy()))
        err = np.abs(got - want) - ulp
        assert (err[sel] <= 1e-3 * lr).all(), k
        worst = max(worst, float(err[sel].max(initial=0)) / lr)
    return worst


def test_sharded_train_step_matches_reference(refs):
    """One train step of reduced qwen with 2 microbatches on (2, 2)
    against the reference's `jit_train_step` on its (2, 2) mesh: loss and
    grad norm rtol 1e-5, every update within 1e-3 lr plus two ulps where
    the gradient stands clear of rounding, every replica bit-equal; the
    bound step's placements and meta example arguments."""
    cfg = dataclasses.replace(parity_cfg(0), microbatches=2)
    mesh = cpu_mesh((2, 2))
    m = sharded_model(cfg, mesh, draw(Model(cfg, device="meta").specs(), 70))
    before = m.state_dict()
    opt_cfg = dataclasses.replace(ST.make_opt_cfg(cfg), warmup_steps=1)
    step, (p_abs, o_abs, b_abs) = ST.jit_train_step(
        m, opt_cfg, mesh, ShapeConfig("t", "train", SEQ, BATCH))
    assert b_abs["tokens"].value.device.type == "meta"
    assert b_abs["tokens"].sharding.spec == (("data",), None)
    assert p_abs["embed"]["tok"].sharding.spec == ("model", "data")
    assert o_abs.m["ln_f"].value.shape == (cfg.d_model,)
    state, metrics = step(adamw.init(m.params(), opt_cfg),
                          tbatch(batch_of(cfg, 80)))
    for k in ("loss", "grad_norm"):
        want = float(refs[f"step/{k}"])
        assert abs(float(metrics[k]) - want) <= 1e-5 * abs(want), k
    assert_replicas_equal(m.params())
    assert_replicas_equal(state)
    step_update_check(
        m, before,
        {k[len("step/params/"):]: v for k, v in refs.items()
         if k.startswith("step/params/")},
        {k[len("step/m/"):]: v for k, v in refs.items()
         if k.startswith("step/m/")}, opt_cfg.lr, opt_cfg.b1)


def serve(m: Model, prompt, toks, caches) -> tuple:
    """Prefill logits, then teacher-forced decode logits from `caches`."""
    out = [m.prefill(dict(tokens=prompt))[0]]
    for i in range(toks.shape[1]):
        lg, caches = m.decode_step(caches, toks[:, i:i + 1])
        out.append(lg)
    return out, caches


def test_prefill_and_decode_over_mesh():
    """Prefill and 8 decode steps of reduced qwen (float32 compute) on
    (2, 2), its 16-kv-head variant and the (2, 2, 2) mesh against the
    unsharded port: float32 caches at rtol 1e-4; the bf16 and int8 caches
    within one rounding step of the unsharded run's; the prefill caches
    gathered within one bf16 ulp; a decode past the end raises before a
    write; `jit_decode_step`'s cache placements."""
    gen = torch.Generator().manual_seed(21)
    for i, shape, names in ((0, (2, 2), None), (1, (2, 2), None),
                            (0, (2, 2, 2), ("pod", "data", "model"))):
        for quant in (False, True):
            cfg = dataclasses.replace(parity_cfg(i), kv_quant=quant)
            prompt = torch.randint(0, cfg.vocab_size, (BATCH, 16),
                                   generator=gen)
            toks = torch.randint(0, cfg.vocab_size, (BATCH, 8),
                                 generator=gen)
            one = Model(cfg, device="cpu", seed=5)
            sh = Model(cfg, device="cpu", seed=5,
                       mesh=cpu_mesh(shape, names or ("data", "model")))
            runs = {}
            for label, mk in (("f32", float32_caches), ("cache", lambda c: c)):
                if quant and label == "f32":
                    continue
                # Caches of the decode's length: each model position's
                # block of the sequence is written.
                runs[label] = (serve(one, prompt, toks,
                                     mk(one.init_caches(BATCH, 8))),
                               serve(sh, prompt, toks,
                                     mk(sh.init_caches(BATCH, 8))))
            if not quant:
                (want, _), (got, _) = runs["f32"]
                for g, w in zip(got, want):
                    scale = float(w.abs().max())
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=1e-4, atol=1e-4 * scale)
            (_, wc), (_, gc) = runs["cache"]
            for a, b in zip(flatten(gc["kv"]), flatten(wc["kv"])):
                assert cache_steps(a, b) <= 1
            for a, b in zip(sh.prefill(dict(tokens=prompt))[1]["kv"],
                            one.prefill(dict(tokens=prompt))[1]["kv"]):
                assert cache_steps(a, b) <= 1
    c = sh.init_caches(BATCH, 2)
    c = dict(c, pos=2)
    with pytest.raises(ValueError, match="past the end"):
        sh.decode_step(c, toks[:, :1])
    _, (_, c_abs, t_abs) = ST.jit_decode_step(
        sh, sh.mesh, ShapeConfig("d", "decode", 32, BATCH))
    assert c_abs["kv"]["kv"][0].sharding.spec == (
        None, ("pod", "data"), "model", None, None)
    assert t_abs.sharding.spec == (("pod", "data"), None)


def test_batch_rule_one_and_indivisible():
    """B = 1 and B = 3 on (2, 2) stay replicated over the data rows: the
    loss, a train step and B = 1 serving equal the unsharded run; caches
    for B = 3 are refused (the rule shards a batch of more than one
    sequence over "dp", which 2 does not divide)."""
    cfg = dataclasses.replace(parity_cfg(0), microbatches=1)
    mesh = cpu_mesh((2, 2))
    assert ST.batch_rule(3, mesh) is None and ST.batch_rule(1, mesh) is None
    assert ST.batch_rule(4, mesh) == ("data",)
    for b in (1, 3):
        batch = tbatch(batch_of(cfg, 90 + b, b))
        one = Model(cfg, device="cpu", seed=6)
        sh = Model(cfg, device="cpu", seed=6, mesh=mesh)
        l1, l2 = float(one.loss(batch)), float(sh.loss(batch))
        assert abs(l1 - l2) <= 1e-5 * abs(l1)
        opt_cfg = ST.make_opt_cfg(cfg)
        for m in (one, sh):
            ST.make_train_step(m, opt_cfg, m.mesh)(
                adamw.init(m.params(), opt_cfg), batch)
        assert_replicas_equal(sh.params())
        for k, v in one.state_dict().items():
            assert float((sh.state_dict()[k] - v).abs().max()) <= 1e-6, k
    prompt = torch.randint(0, cfg.vocab_size, (1, 8))
    w, _ = serve(one, prompt, prompt, float32_caches(one.init_caches(1, 8)))
    g, _ = serve(sh, prompt, prompt, float32_caches(sh.init_caches(1, 8)))
    for a, b_ in zip(g, w):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(b_.abs().max()))
    with pytest.raises(ValueError, match="cannot be sharded"):
        sh.init_caches(3, 8)


def test_non_dense_family_refused_on_a_mesh():
    """Every non-dense arch on a (2, 1) mesh raises NotImplementedError
    naming the next slice; on (1, 1) it runs as on one device."""
    for name in ALL_ARCHS:
        cfg = T.reduced(T.get_arch(name))
        if cfg.family in ("dense", "vlm", "audio"):
            continue
        with pytest.raises(NotImplementedError, match="next LM mesh slice"):
            Model(cfg, device="cpu", mesh=cpu_mesh((2, 1)))
        m = Model(cfg, device="cpu", seed=0, mesh=cpu_mesh((1, 1)))
        assert m.mesh.size == 1 and m.params()["ln_f"].device == CPU


def test_sharded_checkpoint_resume_and_elastic_reshard(tmp_path):
    """2 steps on (2, 2), saved by a `FaultManager` (the gathered state)
    and restored; `elastic_reshard` onto (1, 4) and (1, 1): the gathered
    state bit-equal; 2 more steps on each mesh equal, bit for bit, the
    same steps from the gathered state placed directly; numpy (`convert`)
    to a sharded model and back bit-equal."""
    cfg = parity_cfg(0)
    opt_cfg = ST.make_opt_cfg(cfg)
    src = Model(cfg, device="cpu", seed=8, mesh=cpu_mesh((2, 2)))
    state = adamw.init(src.params(), opt_cfg)
    step = ST.make_train_step(src, opt_cfg, src.mesh)
    batches = [tbatch(batch_of(cfg, 100 + i)) for i in range(4)]
    for b in batches[:2]:
        state, _ = step(state, b)
    fm = FaultManager(FaultConfig(ckpt_dir=str(tmp_path), save_every=2,
                                  install_sigterm_hook=False))
    fm.maybe_save(2, (src.params(), state))
    saved = [x.gather() if isinstance(x, D.Sharded) else x
             for x in flatten((src.params(), state))]
    host = (pspec.tree_map(lambda t: t.gather(), src.params()),
            D.gather_tree(state))
    (params, restored), at = fm.restore_latest(host)
    assert at == 2
    for a, b in zip(flatten((params, restored)), saved):
        assert torch.equal(a, b)
    for shape in ((1, 4), (1, 1)):
        mesh = cpu_mesh(shape)
        specs = pspec.partition_specs(src.specs(), mesh)
        o_specs = adamw.OptState(m=specs, v=specs, step=())
        p2 = elastic_reshard(params, mesh, specs)
        s2 = elastic_reshard(restored, mesh, o_specs)
        for a, b in zip(flatten((p2, s2)), saved):
            a = a.gather() if isinstance(a, D.Sharded) else a
            assert torch.equal(a, b)
        outs = []
        for how in ("resharded", "direct"):
            m = Model(cfg, device="cpu", seed=0, mesh=mesh)
            if how == "resharded":
                m.load_state_dict({k: t.gather() for k, t in
                                   pspec.leaves(p2)})
                st = s2 if mesh.size > 1 else D.gather_tree(s2)
            else:
                m.load_state_dict(dict(pspec.leaves(params)))
                st = restored if mesh.size == 1 else elastic_reshard(
                    restored, mesh, o_specs)
            s = ST.make_train_step(m, opt_cfg, mesh)
            for b in batches[2:]:
                st, _ = s(st, b)
            outs.append([x.gather() if isinstance(x, D.Sharded) else x
                         for x in flatten((m.params(), st))])
        for a, b in zip(*outs):
            assert torch.equal(a, b), shape
    back = convert.lm_params_to_numpy(src)
    again = Model(cfg, device="cpu", mesh=cpu_mesh((2, 2)))
    again.load_state_dict(convert.lm_params_from_numpy(back))
    for k, v in src.state_dict().items():
        assert torch.equal(again.state_dict()[k], v)
    ostate = convert.lm_opt_state_to_numpy(state)
    assert ostate["m"]["ln_f"].shape == (cfg.d_model,)


def test_driver_production_mesh_raises():
    """`launch.train` with `--production-mesh` or `--multi-pod` builds the
    production mesh over the visible CUDA devices; with fewer than 256
    (512) it raises ValueError with the count before any step."""
    base = ["--device", "cpu", "--arch", "qwen1.5-0.5b", "--reduced",
            "--steps", "1"]
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs 256 devices; {n} were"):
        TR.main(base + ["--production-mesh"])
    with pytest.raises(ValueError, match=f"needs 512 devices; {n} were"):
        TR.main(base + ["--multi-pod"])


def spreads(ref_path: str) -> None:
    """Print the measured spreads the module docstring quotes, against the
    reference's outputs at `ref_path` (written by this script first)."""
    refs = dict(np.load(ref_path))
    mesh = cpu_mesh((2, 2))
    for i in range(len(PARITY)):
        cfg = parity_cfg(i)
        flat = draw(Model(cfg, device="meta").specs(), 70 + i)
        loss, grads = grads_gathered(sharded_model(cfg, mesh, flat),
                                     tbatch(batch_of(cfg, 80 + i)))
        want = float(refs[f"loss{i}/loss"])
        g = max(float(np.abs(grads[k].numpy() - w).max() / np.abs(w).max())
                for k, w in ((k, refs[f"loss{i}/grads/{k}"]) for k in grads))
        print(f"{PARITY[i]}: loss {abs(float(loss) - want) / want:.2e}, "
              f"gradients {g:.2e} of the leaf's largest")
    cfg = dataclasses.replace(parity_cfg(0), microbatches=2)
    m = sharded_model(cfg, mesh, draw(Model(cfg, device="meta").specs(), 70))
    before = m.state_dict()
    opt_cfg = dataclasses.replace(ST.make_opt_cfg(cfg), warmup_steps=1)
    _, metrics = ST.make_train_step(m, opt_cfg, mesh)(
        adamw.init(m.params(), opt_cfg), tbatch(batch_of(cfg, 80)))
    rel = {k: abs(float(metrics[k]) - float(refs[f"step/{k}"]))
           / float(refs[f"step/{k}"]) for k in ("loss", "grad_norm")}
    worst = step_update_check(
        m, before, {k[12:]: v for k, v in refs.items()
                    if k.startswith("step/params/")},
        {k[7:]: v for k, v in refs.items() if k.startswith("step/m/")},
        opt_cfg.lr, opt_cfg.b1)
    print(f"train step: loss {rel['loss']:.2e}, grad norm "
          f"{rel['grad_norm']:.2e}, update {worst:.2e} lr past two ulps")
    gen = torch.Generator().manual_seed(21)
    for quant in (False, True):
        cfg = dataclasses.replace(parity_cfg(0), kv_quant=quant)
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, 16), generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (BATCH, 8), generator=gen)
        one = Model(cfg, device="cpu", seed=5)
        sh = Model(cfg, device="cpu", seed=5, mesh=mesh)
        for label, mk in (("float32 caches", float32_caches),
                          ("model's caches", lambda c: c)):
            if quant and label == "float32 caches":
                continue
            (w, wc), (g, gc) = (serve(x, prompt, toks,
                                      mk(x.init_caches(BATCH, 16)))
                                for x in (one, sh))
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(g, w))
            print(f"serving, kv_quant={quant}, {label}: logits "
                  f"{err:.2e} x max|logit|")


if __name__ == "__main__":
    if sys.argv[1] == "--spreads":
        spreads(sys.argv[2])
    else:
        write_reference(sys.argv[1])
