"""The port's MoE/MLA, SSM, hybrid and enc-dec LM families over a mesh
(`models.moe.moe_apply_tp`, `mla.*_tp`, `mamba2.*_tp`, the family
`*_block_tp` of `models.blocks`, `Model`'s mesh path, Adafactor on
shards) against the JAX reference's sharded path on the CPU, and against
the port on one device.

Archs: deepseek-v2-lite-16b (MoE with MLA, shared experts, a first dense
layer), arctic-480b (MoE with GQA and a dense residual, Adafactor),
mamba2-780m (SSM), zamba2-1.2b (hybrid; 4 layers at `attn_every` 2 here,
so two groups share the attention block) and seamless-m4t-large-v2
(enc-dec), each `reduced` with float32 compute, parameters and gradient
accumulation (arctic's own are bf16) and `attn_chunk` 8. Weights and batches are numpy draws from a seed
(`test_torch_lm_mesh.draw`), carried by `convert`; the enc-dec's encoder
input is 32 frames of N(0, 1).

Meshes are repeated CPU devices: (data=2, model=2) and (pod=2, data=2,
model=2). The reference runs once, in a subprocess started by an autouse
fixture (`python tests/test_torch_lm_mesh_families.py OUT.npz` writes its
outputs), on 8 host devices with `jax.sharding.Mesh(np.array(devices)
.reshape(...), names)`, its parameters placed by its rules; every
family's sharded path runs under this JAX, so each is held against it:
`moe_apply` and `mamba_train` with their `mesh`, the value and gradient
of `Model.loss`, and one `jit_train_step` (2 microbatches; AdamW at the
full rate, arctic's Adafactor with factored moments from 32 on (2, 2, 2)
under `fsdp_over_pod`).

Tolerances (float32; in brackets what an x86 CPU measured, printed by
`python tests/test_torch_lm_mesh_families.py --spreads REF.npz` after the
reference's run has written REF.npz):
  moe_apply        y within 1e-5 of max|y| [3.9e-7], aux rtol 1e-6
                   [1.2e-7]; slots and keeps equal to the one-device
                   routing's of the whole batch, which
                   `test_torch_lm_families.py` holds to the reference's,
                   with capacity drops in every case and groups that span
                   the data rows
  SSM mixer        within 1e-5 of max|y| [9.3e-7]
  loss             rtol 1e-5 [1.5e-7]
  gradients        each leaf within 4e-5 of its largest |g| for the MoE
                   and SSM archs [1.4e-5], 2e-4 for the hybrid and the
                   enc-dec [9.5e-5, 6.2e-5]: the port on one device is
                   as far from the reference [9.0e-5, 6.7e-5], so this
                   is how far float32 sums in another order move these
                   two models' gradients (the enc-dec's cross-attention
                   reads unit-scale encoder frames that every layer's
                   residual carries), not a cost of the mesh
  train step       loss and grad norm rtol 1e-5 [1.5e-7, 2.0e-6]; each
                   parameter's update within 1e-3 lr plus two float32
                   ulps where the reference's gradient exceeds 1e-2 of its
                   leaf's largest (read from AdamW's first moment, or
                   from Adafactor's first-step v of an unfactored leaf;
                   every element of a factored leaf) [5.0e-5 lr]; every
                   replica bit-equal
  serving          prefill and 8 decode steps over (2, 2) against one
                   device: float32 caches rtol 1e-4, atol 1e-4 x
                   max|logit| [7.7e-6, the enc-dec]; the model's bf16
                   caches each element within one rounding step; the
                   SSM's and the hybrid's, which read back the bf16 state
                   they wrote, so that a rounding flip one step feeds the
                   next, within `test_torch_lm_families.py`'s bound for
                   them, max |d| <= 1.5e-2 x max|x| and relative RMS <=
                   3e-3 [4.4e-3 and 9.4e-4, the hybrid]
  checkpoints      bit-equal

The file holds 11 tests, so the tier-1 xdist queue starts it after
`test_stream_properties.py`.
"""
import dataclasses
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
from repro_torch.launch import steps as ST
from repro_torch.models import blocks as B
from repro_torch.models import mamba2 as S
from repro_torch.models import moe as E
from repro_torch.models import pspec
from repro_torch.models.model import Model
from repro_torch.models.parity import cache_steps, float32_caches
from repro_torch.optim import adafactor, adamw

from test_torch_lm import REF_XLA_FLAGS
from test_torch_lm_families import FAST_XLA_FLAGS
from test_torch_lm_mesh import (BATCH, SEQ, assert_replicas_equal, batch_of,
                                cpu_mesh, draw, grads_gathered, nest,
                                sharded_model)
from test_torch_lm_train import ONE_THREAD_XLA_FLAGS

FAMILIES = ("deepseek-v2-lite-16b", "arctic-480b", "mamba2-780m",
            "zamba2-1.2b", "seamless-m4t-large-v2")
POD = ("pod", "data", "model")
STEP_BATCH = 8
# moe_apply cases: (batch, seq): a decode step (one group of 4 tokens over
# two rows), a group of 64 over two rows, and rows of whole groups.
MOE_CASES = {"decode": (4, 1), "span": (8, 8), "aligned": (4, 32)}
MOE_CAPACITY = 0.5


def fam_cfg(name: str, mod=T, **extra):
    cfg = dataclasses.replace(mod.reduced(mod.get_arch(name)),
                              dtype="float32", param_dtype="float32",
                              moment_dtype="float32", attn_chunk=8, **extra)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=4)
    return cfg


def step_cfg(name: str, mod=T):
    """The train step's config: 2 microbatches; arctic under
    `fsdp_over_pod` (its own setting) for the (2, 2, 2) mesh."""
    return fam_cfg(name, mod, microbatches=2,
                   fsdp_over_pod=name == "arctic-480b")


def step_mesh_of(name: str):
    return ((2, 2, 2), POD) if name == "arctic-480b" else ((2, 2),
                                                          ("data", "model"))


def opt_cfg_of(cfg, mod):
    """The family's optimizer at the full rate; Adafactor factors from 32
    so that the reduced widths factor."""
    oc = dataclasses.replace(mod.make_opt_cfg(cfg), warmup_steps=1)
    if cfg.optimizer == "adafactor":
        oc = dataclasses.replace(oc, min_dim_size_to_factor=32)
    return oc


def fam_batch(cfg, seed: int, b: int = BATCH) -> dict:
    out = batch_of(cfg, seed, b)
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed + 1000)
        out["enc_embeds"] = rng.normal(0, 1, (b, SEQ, cfg.d_model)) \
            .astype(np.float32)
    return out


def tbatch(d: dict) -> dict:
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in d.items()}


def shape_of(cfg, b: int) -> ShapeConfig:
    """The train ShapeConfig of a (b, SEQ) batch (the enc-dec's input
    specs halve the sequence between encoder and decoder)."""
    s = 2 * SEQ if cfg.family == "encdec" else SEQ
    return ShapeConfig("t", "train", s, b)


def moe_inputs(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1, shape + (64,)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# The reference (subprocess)
# ---------------------------------------------------------------------------

def write_reference(path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import repro.configs as R
    from repro.launch import steps as JST
    from repro.models import mamba2 as JS
    from repro.models import moe as JE
    from repro.models import pspec as jpspec
    from repro.models.model import Model as JModel
    from repro.optim import adafactor as jaf
    from repro.optim import adamw as jadamw

    devs = np.array(jax.devices())

    def mesh_of(shape, names):
        return Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
    m22 = mesh_of((2, 2), ("data", "model"))
    out = {}
    jobs = []

    def place(flat, specs, mesh, fop=False):
        return jax.device_put(jax.tree.map(jnp.asarray, nest(flat)),
                              jpspec.shardings(specs, mesh, fop))

    def replicated(x, mesh):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh,
                                                            PartitionSpec()))
    for name, cases in (("deepseek-v2-lite-16b", MOE_CASES),
                        ("arctic-480b", {"span": MOE_CASES["span"]})):
        cfg = fam_cfg(name, R, capacity_factor=MOE_CAPACITY)
        specs = JE.moe_specs(cfg)
        p = place(draw(specs, 11), specs, m22)
        for case, shape in cases.items():
            x = replicated(moe_inputs(12, shape), m22)
            fn = jax.jit(lambda p, x, cfg=cfg: JE.moe_apply(p, x, cfg, m22))
            jobs.append((f"moe/{name}/{case}", fn, (p, x)))
    cfg = fam_cfg("mamba2-780m", R)
    specs = JS.mamba_specs(cfg)
    fn = jax.jit(lambda p, x, cfg=cfg: JS.mamba_train(p, x, cfg, m22))
    jobs.append(("ssm", fn, (place(draw(specs, 13), specs, m22),
                             replicated(moe_inputs(14, (BATCH, SEQ)), m22))))

    for i, name in enumerate(FAMILIES):
        cfg = fam_cfg(name, R)
        model = JModel(cfg)
        flat = draw(model.specs(), 30 + i)
        batch = {k: jnp.asarray(v) for k, v in fam_batch(cfg, 40 + i)
                 .items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, model=model: model.loss(p, b, m22)))
        jobs.append((f"{name}/loss", fn, (place(flat, model.specs(), m22),
                                          batch)))

        cfg = step_cfg(name, R)
        model = JModel(cfg)
        opt_cfg = opt_cfg_of(cfg, JST)
        mesh = mesh_of(*step_mesh_of(name))
        fn, _ = JST.jit_train_step(model, opt_cfg, mesh,
                                   shape_of(cfg, STEP_BATCH))
        params = jax.tree.map(jnp.asarray, nest(draw(model.specs(), 30 + i)))
        opt = jaf if cfg.optimizer == "adafactor" else jadamw
        state = opt.init(params, opt_cfg)
        batch = {k: jnp.asarray(v) for k, v in fam_batch(
            cfg, 50 + i, STEP_BATCH).items()}
        jobs.append((f"{name}/step", fn, (params, state, batch)))

    for key, fn, args in jobs:
        res = fn(*args)
        if key.startswith(("moe/")):
            out[f"{key}/y"], out[f"{key}/aux"] = map(np.asarray, res)
        elif key == "ssm":
            out["ssm/y"] = np.asarray(res)
        elif key.endswith("/loss"):
            loss, grads = res
            out[key] = np.asarray(loss)
            out.update({f"{key[:-5]}/grads/{k}": np.asarray(v)
                        for k, v in pspec.leaves(grads)})
        else:
            p2, s2, metrics = res
            out.update({f"{key}/params/{k}": np.asarray(v)
                        for k, v in pspec.leaves(p2)})
            if hasattr(s2, "m"):
                out.update({f"{key}/m/{k}": np.asarray(v)
                            for k, v in pspec.leaves(s2.m)})
            else:
                out.update({f"{key}/v/{k}": np.asarray(v.full)
                            for k, v in pspec.leaves(s2.v)
                            if np.ndim(v.full)})
            out.update({f"{key}/{k}": np.asarray(v)
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
    d = tmp_path_factory.mktemp("lm_mesh_families")
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

def row_inputs(specs, flat: dict, mesh, fop: bool = False) -> list:
    """The FSDP-gathered pieces of a layer's weights drawn as `flat`,
    placed on `mesh` by the rules: per data row a tree of per-position
    lists."""
    tree = D.shard_tree(nest(convert.lm_params_from_numpy(nest(flat))),
                        pspec.shardings(specs, mesh, fop))
    g = B.fsdp_gather(tree, mesh)
    return [B.row_params(g, row) for row in mesh.rows()]


def moe_tp(cfg, flat, x, mesh) -> tuple:
    """`moe_apply_tp` of the batch `x` split over the data rows of
    `mesh`: (whole y, aux, routing)."""
    ps = row_inputs(E.moe_specs(cfg), flat, mesh)
    n = len(mesh.rows())
    devs = [[CPU] * mesh.shape["model"]] * n
    xs = [[c] * mesh.shape["model"] for c in x.chunk(n)]
    ys, aux, routing = E.moe_apply_tp(ps, xs, cfg, devs, split=True)
    return torch.cat([sum(y) for y in ys]), aux, routing


CPU = torch.device("cpu")


def select_update_error(m: Model, before: dict, want: dict, grads: dict,
                        lr: float) -> float:
    """The worst |Δ update| / lr past two float32 ulps over the elements
    whose reference gradient `grads[k]` (|g|) exceeds 1e-2 of its leaf's
    largest; over every element of a leaf without one (a factored
    Adafactor leaf: its update is g / sqrt(v) with v factored over whole
    rows and columns, so a gradient lost in rounding moves its parameter
    by as little)."""
    worst = 0.0
    for k, after in m.state_dict().items():
        if k in grads:
            sel = grads[k] > 1e-2 * grads[k].max()
        else:
            sel = np.ones(after.shape, bool)
        got = (after - before[k]).numpy()
        ulp = 2 * np.spacing(np.abs(after.numpy()))
        err = np.abs(got - (want[k] - before[k].numpy())) - ulp
        worst = max(worst, float(err[sel].max(initial=0)) / lr)
    return worst


def step_refs(refs, name: str) -> tuple:
    """The reference step's parameters and each leaf's |g| where it can
    be read: AdamW's first moment / (1 - b1), or at Adafactor's first
    step sqrt(v - eps) of an unfactored leaf (its decay is 0 there)."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in refs.items()
                if k.startswith(prefix)}
    grads = {k: np.abs(v) / 0.1 for k, v in sub(f"{name}/step/m/").items()}
    grads.update({k: np.sqrt(np.maximum(v - 1e-30, 0))
                  for k, v in sub(f"{name}/step/v/").items()})
    return sub(f"{name}/step/params/"), grads


def bf16_state_close(got, want) -> bool:
    """The bound of `test_torch_lm_families.py` for caches of an arch that
    reads back bf16 state it wrote: max |d| <= 1.5e-2 x max|x| and
    relative RMS <= 3e-3."""
    a = (got.gather() if isinstance(got, D.Sharded) else got).float()
    b = want.float()
    d = a - b
    return bool(d.abs().max() <= 1.5e-2 * b.abs().max()
                and d.pow(2).mean().sqrt() <= 3e-3 * b.pow(2).mean().sqrt())


def serve(m: Model, batch: dict, toks, caches) -> tuple:
    """Prefill logits, then teacher-forced decode logits from `caches`;
    the enc-dec's decode reads the prefill's encoder output."""
    pre = {k: v for k, v in batch.items() if k != "labels"}
    first, pc = m.prefill(pre)
    if "enc_out" in caches:
        caches = dict(caches, enc_out=pc["enc_out"])
    out = [first]
    for i in range(toks.shape[1]):
        lg, caches = m.decode_step(caches, toks[:, i:i + 1])
        out.append(lg)
    return out, caches, pc


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_prefill_and_decode_over_mesh():
    """Prefill and 8 decode steps of every family on (2, 2) against one
    device from the same weights: float32 caches rtol 1e-4; the model's
    own (bf16) caches within one rounding step (the SSM and the hybrid,
    which read back the bf16 state they wrote, within the bound of
    `test_torch_lm_families.py`), and its prefill caches gathered within
    one bf16 ulp; a batch that does not match the caches' placement is
    refused."""
    gen = torch.Generator().manual_seed(31)
    mesh = cpu_mesh((2, 2))
    for name in FAMILIES:
        cfg = fam_cfg(name)
        one = Model(cfg, device="cpu", seed=7)
        sh = Model(cfg, device="cpu", seed=7, mesh=mesh)
        batch = tbatch(fam_batch(cfg, 60))
        toks = torch.randint(0, cfg.vocab_size, (BATCH, 8), generator=gen)
        n = SEQ if cfg.family == "encdec" else 8
        (want, _, wp), (got, _, gp) = (serve(m, batch, toks, float32_caches(
            m.init_caches(BATCH, n))) for m in (one, sh))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4 * float(w.abs().max()),
                                       err_msg=name)
        for a, b in zip(flatten(gp), flatten(wp)):
            assert cache_steps(a, b) <= 1, name
        (_, wc, _), (_, gc, _) = (serve(m, batch, toks,
                                        m.init_caches(BATCH, n))
                                  for m in (one, sh))
        for a, b in zip(flatten(gc), flatten(wc)):
            if not torch.is_tensor(b):
                continue
            if cfg.family in ("ssm", "hybrid"):
                assert bf16_state_close(a, b), name
            else:
                assert cache_steps(a, b) <= 1, name
    with pytest.raises(ValueError, match="against caches placed"):
        sh.decode_step(sh.init_caches(BATCH, n), toks[:1, :1])


def test_sharded_checkpoint_and_elastic_reshard():
    """Each family float32: 2 steps on (2, 2), saved by a `FaultManager`
    and restored bit-equal; `elastic_reshard` onto (1, 4) and (1, 1)
    bit-equal gathered; one more step on each bit-equal to the same step
    from the gathered state placed directly (arctic's Adafactor state by
    `adafactor_shardings`)."""
    import tempfile
    for i, name in enumerate(FAMILIES):
        cfg = fam_cfg(name, microbatches=1)
        opt_cfg = opt_cfg_of(cfg, ST)
        opt = adafactor if cfg.optimizer == "adafactor" else adamw
        src = Model(cfg, device="cpu", seed=9, mesh=cpu_mesh((2, 2)))
        state = opt.init(src.params(), opt_cfg)
        step = ST.make_train_step(src, opt_cfg, src.mesh)
        batches = [tbatch(fam_batch(cfg, 70 + j)) for j in range(3)]
        for b in batches[:2]:
            state, _ = step(state, b)
        with tempfile.TemporaryDirectory() as d:
            fm = FaultManager(FaultConfig(ckpt_dir=d, save_every=2,
                                          install_sigterm_hook=False))
            fm.maybe_save(2, (src.params(), state))
            host = (pspec.tree_map(lambda t: t.gather(), src.params()),
                    D.gather_tree(state))
            (params, restored), at = fm.restore_latest(host)
        assert at == 2
        for a, b in zip(flatten((params, restored)), flatten(host)):
            assert torch.equal(a, b), name
        for shape in ((1, 4), (1, 1)):
            mesh = cpu_mesh(shape)
            specs = pspec.partition_specs(src.specs(), mesh)
            if opt is adafactor:
                o_specs = D.map_with(lambda s, _: s.spec, ST.adafactor_shardings(
                    Model(cfg, device="meta"), mesh, opt_cfg),
                    ST.adafactor_shardings(Model(cfg, device="meta"), mesh,
                                           opt_cfg))
            else:
                o_specs = adamw.OptState(m=specs, v=specs, step=())
            p2 = elastic_reshard(params, mesh, specs)
            s2 = elastic_reshard(restored, mesh, o_specs)
            for a, b in zip(flatten((p2, s2)), flatten(host)):
                a = a.gather() if isinstance(a, D.Sharded) else a
                assert torch.equal(a, b), (name, shape)
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
                st, _ = ST.make_train_step(m, opt_cfg, mesh)(st, batches[2])
                outs.append([x.gather() if isinstance(x, D.Sharded) else x
                             for x in flatten((m.params(), st))])
            for a, b in zip(*outs):
                assert torch.equal(a, b), (name, shape)


def test_imports_without_jax():
    """The port's mesh modules and their importers import no `jax` and no
    `repro` (both blocked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.models.model, repro_torch.models.moe\n"
        "import repro_torch.models.mla, repro_torch.models.mamba2\n"
        "import repro_torch.optim.adafactor, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_moe_expert_parallel_matches_reference(refs):
    """`moe_apply_tp` on (2, 2) with capacity factor 0.5: a decode step of
    4 tokens (one group over both data rows), a group of 64 over both rows
    and rows of whole groups (deepseek: shared experts), and arctic (dense
    residual) on the group over both rows: y and aux against the
    reference's `moe_apply` on its (2, 2) mesh; slots and keeps equal to
    the one-device routing of the whole batch, with drops in each."""
    mesh = cpu_mesh((2, 2))
    for name, cases in (("deepseek-v2-lite-16b", MOE_CASES),
                        ("arctic-480b", {"span": MOE_CASES["span"]})):
        cfg = fam_cfg(name, capacity_factor=MOE_CAPACITY)
        flat = draw(E.moe_specs(cfg), 11)
        p1 = convert.lm_params_from_numpy(nest(flat))
        for case, shape in cases.items():
            x = torch.from_numpy(moe_inputs(12, shape))
            y, aux, routing = moe_tp(cfg, flat, x, mesh)
            want = refs[f"moe/{name}/{case}/y"]
            np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{name} {case}")
            wa = float(refs[f"moe/{name}/{case}/aux"])
            assert abs(float(aux) - wa) <= 1e-6 * wa, (name, case)
            tokens = x.reshape(-1, cfg.d_model)
            one = E.route(tokens, p1["router"], cfg,
                          E.group_size(cfg, tokens.shape[0]))
            assert torch.equal(routing["slot"], one.slot), (name, case)
            assert torch.equal(routing["keep"], one.keep), (name, case)
            assert not bool(one.keep.all()), (name, case, "no drops")


def test_ssm_mixer_over_mesh_matches_reference(refs):
    """`mamba_train_tp` on each data row of (2, 2) (in_proj's [x | z]
    paired per position, the gated norm's sum of squares over "model")
    against the reference's `mamba_train` on its (2, 2) mesh; a model axis
    that does not divide the heads is refused."""
    cfg = fam_cfg("mamba2-780m")
    mesh = cpu_mesh((2, 2))
    x = torch.from_numpy(moe_inputs(14, (BATCH, SEQ)))
    ps = row_inputs(S.mamba_specs(cfg), draw(S.mamba_specs(cfg), 13), mesh)
    y = torch.cat([sum(S.mamba_train_tp(p, [xr, xr], cfg, [CPU, CPU]))
                   for p, xr in zip(ps, x.chunk(2))])
    want = refs["ssm/y"]
    np.testing.assert_allclose(y.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="do not divide its 8 SSM heads"):
        Model(cfg, device="cpu", mesh=cpu_mesh((1, 16)))


@pytest.mark.parametrize("name", FAMILIES)
def test_sharded_loss_and_grads_match_reference(refs, name):
    """float32 loss and every gradient leaf on (2, 2) against the
    reference's sharded `Model.loss`; the hybrid's shared block (used by
    two groups) included."""
    i = FAMILIES.index(name)
    cfg = fam_cfg(name)
    flat = draw(Model(cfg, device="meta").specs(), 30 + i)
    loss, grads = grads_gathered(sharded_model(cfg, cpu_mesh((2, 2)), flat),
                                 tbatch(fam_batch(cfg, 40 + i)))
    want = float(refs[f"{name}/loss"])
    assert abs(float(loss) - want) <= 1e-5 * abs(want)
    tol = 2e-4 if cfg.family in ("hybrid", "encdec") else 4e-5
    for k, g in grads.items():
        w = refs[f"{name}/grads/{k}"]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol * float(np.abs(w).max()),
                                   err_msg=k)
    if cfg.family == "hybrid":
        assert any(k.startswith("shared_attn.") for k in grads)


def test_sharded_train_steps_match_reference(refs):
    """One `make_train_step` (2 microbatches) per family against the
    reference's `jit_train_step`: AdamW on (2, 2), arctic's Adafactor on
    (2, 2, 2) under `fsdp_over_pod` with factored moments; loss, grad
    norm, updates and replicas; Adafactor's sharded moments placed as
    `adafactor_shardings` places them."""
    for i, name in enumerate(FAMILIES):
        cfg = step_cfg(name)
        mesh = cpu_mesh(*step_mesh_of(name))
        m = sharded_model(cfg, mesh, draw(Model(cfg, device="meta").specs(),
                                          30 + i))
        before = m.state_dict()
        opt_cfg = opt_cfg_of(cfg, ST)
        opt = adafactor if cfg.optimizer == "adafactor" else adamw
        state = opt.init(m.params(), opt_cfg)
        if opt is adafactor:
            want = ST.adafactor_shardings(m, mesh, opt_cfg)
            got = state.v["layers"]["moe"]["wi"]
            assert got.row.sharding.spec == want.v["layers"]["moe"][
                "wi"].row.spec == (None, "model", ("pod", "data"))
        state, metrics = ST.make_train_step(m, opt_cfg, mesh)(
            state, tbatch(fam_batch(cfg, 50 + i, STEP_BATCH)))
        for k in ("loss", "grad_norm"):
            w = float(refs[f"{name}/step/{k}"])
            assert abs(float(metrics[k]) - w) <= 1e-5 * abs(w), (name, k)
        assert_replicas_equal(m.params())
        assert_replicas_equal(state)
        assert select_update_error(m, before, *step_refs(refs, name),
                                   opt_cfg.lr) <= 1e-3, name


def spreads(ref_path: str) -> None:
    """Print the measured spreads the module docstring quotes, against the
    reference's outputs at `ref_path` (written by this script first)."""
    refs = dict(np.load(ref_path))
    mesh = cpu_mesh((2, 2))
    for name, cases in (("deepseek-v2-lite-16b", MOE_CASES),
                        ("arctic-480b", {"span": MOE_CASES["span"]})):
        cfg = fam_cfg(name, capacity_factor=MOE_CAPACITY)
        flat = draw(E.moe_specs(cfg), 11)
        for case, shape in cases.items():
            y, aux, _ = moe_tp(cfg, flat, torch.from_numpy(
                moe_inputs(12, shape)), mesh)
            w = refs[f"moe/{name}/{case}/y"]
            wa = float(refs[f"moe/{name}/{case}/aux"])
            print(f"moe_apply {name} {case}: y "
                  f"{np.abs(y.numpy() - w).max() / np.abs(w).max():.2e} of "
                  f"max|y|, aux {abs(float(aux) - wa) / wa:.2e}")
    cfg = fam_cfg("mamba2-780m")
    x = torch.from_numpy(moe_inputs(14, (BATCH, SEQ)))
    ps = row_inputs(S.mamba_specs(cfg), draw(S.mamba_specs(cfg), 13), mesh)
    y = torch.cat([sum(S.mamba_train_tp(p, [xr, xr], cfg, [CPU, CPU]))
                   for p, xr in zip(ps, x.chunk(2))])
    w = refs["ssm/y"]
    print(f"SSM mixer: {np.abs(y.numpy() - w).max() / np.abs(w).max():.2e}")
    for i, name in enumerate(FAMILIES):
        cfg = fam_cfg(name)
        flat = draw(Model(cfg, device="meta").specs(), 30 + i)
        loss, grads = grads_gathered(sharded_model(cfg, mesh, flat),
                                     tbatch(fam_batch(cfg, 40 + i)))
        want = float(refs[f"{name}/loss"])
        g = max(float(np.abs(grads[k].numpy() - w).max() / np.abs(w).max())
                for k, w in ((k, refs[f"{name}/grads/{k}"]) for k in grads))
        one = Model(cfg, device="cpu")
        one.load_state_dict(convert.lm_params_from_numpy(nest(flat)))
        one.requires_grad_(True)
        alone = dict(zip((k for k, _ in pspec.leaves(one.params())),
                         ST.grads_of(one, tbatch(fam_batch(cfg, 40 + i)),
                                     flatten(one.params()))[1]))
        g1 = max(float(np.abs(alone[k].numpy() - w).max() / np.abs(w).max())
                 for k, w in ((k, refs[f"{name}/grads/{k}"]) for k in alone))
        cfg = step_cfg(name)
        smesh = cpu_mesh(*step_mesh_of(name))
        m = sharded_model(cfg, smesh, draw(Model(cfg, device="meta").specs(),
                                           30 + i))
        before = m.state_dict()
        opt_cfg = opt_cfg_of(cfg, ST)
        opt = adafactor if cfg.optimizer == "adafactor" else adamw
        _, met = ST.make_train_step(m, opt_cfg, smesh)(
            opt.init(m.params(), opt_cfg),
            tbatch(fam_batch(cfg, 50 + i, STEP_BATCH)))
        rel = {k: abs(float(met[k]) - float(refs[f"{name}/step/{k}"]))
               / float(refs[f"{name}/step/{k}"]) for k in ("loss",
                                                           "grad_norm")}
        upd = select_update_error(m, before, *step_refs(refs, name),
                                  opt_cfg.lr)
        one = Model(fam_cfg(name), device="cpu", seed=7)
        sh = Model(fam_cfg(name), device="cpu", seed=7, mesh=mesh)
        batch = tbatch(fam_batch(one.cfg, 60))
        toks = torch.randint(0, one.cfg.vocab_size, (BATCH, 8),
                             generator=torch.Generator().manual_seed(31))
        n = SEQ if one.cfg.family == "encdec" else 8
        (wl, _, _), (gl, _, _) = (serve(x, batch, toks, float32_caches(
            x.init_caches(BATCH, n))) for x in (one, sh))
        srv = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(gl, wl))
        (_, wc, _), (_, gc, _) = (serve(x, batch, toks, x.init_caches(
            BATCH, n)) for x in (one, sh))
        pairs = [((a.gather() if isinstance(a, D.Sharded) else a).float(),
                  b.float()) for a, b in zip(flatten(gc), flatten(wc))
                 if torch.is_tensor(b)]
        cmax = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in pairs)
        crms = max(float((a - b).pow(2).mean().sqrt()
                         / b.pow(2).mean().sqrt()) for a, b in pairs)
        print(f"{name}: loss {abs(float(loss) - want) / want:.2e}, "
              f"gradients {g:.2e} of the leaf's largest (one device "
              f"{g1:.2e}); step loss "
              f"{rel['loss']:.2e}, grad norm {rel['grad_norm']:.2e}, "
              f"updates {upd:.2e} lr past two ulps; serving (float32 "
              f"caches) {srv:.2e} x max|logit|, the model's caches after 8 "
              f"steps max |d| {cmax:.2e} x max|x|, relative RMS "
              f"{crms:.2e}")


if __name__ == "__main__":
    if sys.argv[1] == "--spreads":
        spreads(sys.argv[2])
    else:
        write_reference(sys.argv[1])
