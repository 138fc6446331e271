"""The port's LM training slice (`repro_torch.optim`, `data.tokens`,
`launch.steps`, `launch.train`, the differentiable `models.Model` with
remat, LM optimizer states in `convert` and `checkpoint.ckpt`) against
the JAX reference on the CPU.

The reference's train steps are its library path, `launch.steps.
make_train_step(model, opt_cfg, None)` jitted (its `make_local_mesh()`
train tests fail under this JAX in `with_sharding_constraint`). They run
once, in one subprocess whose XLA keeps every bf16 rounding its code
writes and compiles at LLVM -O0 (`test_torch_lm_families.py` explains
both flags); `python tests/test_torch_lm_train.py OUT.npz` writes them.
Archs, reduced with attention and SSD chunks of 8: qwen1.5-0.5b (dense,
nonzero qkv biases, 2 microbatches), deepseek-v2-lite-16b (MoE with MLA
and a first dense layer, 4 microbatches), arctic-480b (Adafactor, bf16
parameters, 16 microbatches accumulated in bf16), mamba2-780m (SSM),
zamba2-1.2b (hybrid, 4 microbatches) and seamless-m4t-large-v2 (enc-dec).
Weights are numpy draws by the reference's init rules, carried by
`convert.lm_params_from_numpy`; batches are numpy draws from a seed. The
step runs at the full rate (`first_step_cfg`: a warmup of one step), so
that its update stands far above float32 rounding and moves bf16
parameters.

Tolerances, and what an x86 CPU measured (`python
tests/test_torch_lm_train.py --spreads` prints the steps' parameter
spreads):

  optimizers     one ulp of the dtype where only elementwise arithmetic
                 decides a value; about twice the measured spread where
                 a float32 reduction enters (`test_optimizers_and_lr_
                 match_reference` lists both)
  compression    exact, the residual too
  train step,    loss, grad norm and lr rtol 1e-4 (measured 2.2e-5);
  float32        every moment within 1e-4 of the leaf's max |value|
                 (measured 6.1e-5). Each parameter's update (after -
                 before) on the elements whose gradient exceeds 1e-2 of
                 the leaf's largest (read from the reference's first
                 moment, (1 - b1) g): within 1e-3 lr plus two float32
                 ulps of the parameter (measured 2.7e-6 lr past the
                 ulps). Below that a gradient is near rounding level and
                 Adam's g / (|g| + eps) may take either sign. Arctic's
                 bf16 parameters within one bf16 ulp (measured
                 bit-equal; 5-88% of each moved leaf's elements move two
                 ulps or more, its norms' 1.0 not at all, in both
                 packages), and its moments, squares of gradients rounded
                 to bf16 and summed over 16 microbatches in bf16, within
                 2.5e-2 of the leaf's max (measured 1.1e-2)
  train step,    a bf16 backward is noisy: the reference's bf16 moments
  bf16           lie 3-75% (relative RMS) from its float32 ones, mostly
                 where it sums in bf16 what torch sums in float32. Held:
                 loss, grad norm and lr rtol 1e-2 (measured 1.7e-3);
                 each moment within relative RMS 0.1 of the reference's
                 (measured 0.048) and at most 1.5x as far from the
                 reference's float32 moment as the reference's bf16 one
                 (measured 1.20x); each parameter's update within 1e-3
                 lr plus two ulps where the reference's gradient exceeds
                 0.1 of its leaf's largest and has the sign of its
                 float32 gradient (measured 5e-5 lr past the ulps; at
                 1e-2 of the largest, bf16 noise flips signs); arctic's
                 parameters moved two bf16 ulps or more by the reference
                 moved the same way by the port on at least 98% of them
                 (measured 99.4%)
  F9             `test_ssd_gradient_is_finite_at_a_full_chunk`

The file holds 11 tests, so the tier-1 xdist queue starts it after
`test_stream_properties.py`.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.checkpoint import ckpt as jckpt
from repro.launch import steps as JST
from repro.models.model import Model as JModel
from repro.optim import adafactor as jafactor
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp

import repro_torch.configs as T
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import tokens as data
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import blocks as B
from repro_torch.models import mamba2 as S
from repro_torch.models.model import Model
from repro_torch.optim import adafactor, adamw, compression

from test_torch_lm import REF_XLA_FLAGS, _leaf_items, f32, rel_rms
from test_torch_lm_families import FAST_XLA_FLAGS

ARCHS = ["qwen1.5-0.5b", "deepseek-v2-lite-16b", "arctic-480b",
         "mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2"]
SEQ = 16
ENC_FRAMES = 8
# F9: reduced mamba2 (2 layers, d_model 64) at one SSD chunk of 256
# tokens, and the chunk at which the reference's gradient stays finite.
F9_SEQ, F9_CHUNK, F9_SMALL_CHUNK = 256, 256, 16
# The subprocess runs beside the other tests (and other test files): its
# tiny computations need no intra-op thread pool. Tracing, not compiling,
# sets its wall (about 44 s on two compile threads or four).
ONE_THREAD_XLA_FLAGS = "--xla_cpu_multi_thread_eigen=false"


def cfgs(name: str, dtype: str, **extra):
    """(reference, port) reduced configs of `name`."""
    kw = dict(dict(attn_chunk=8, ssm_chunk=8, dtype=dtype), **extra)
    return (dataclasses.replace(R.reduced(R.get_arch(name)), **kw),
            dataclasses.replace(T.reduced(T.get_arch(name)), **kw))


def inputs_of(name: str) -> dict:
    """A batch of max(2, microbatches) sequences of SEQ tokens with three
    labels masked (-1); the enc-dec's bf16-valued encoder frames; qwen's
    nonzero qkv biases."""
    cfg = T.reduced(T.get_arch(name))
    rng = np.random.default_rng(40 + ARCHS.index(name))
    b = max(2, cfg.microbatches)
    out = dict(tokens=rng.integers(0, cfg.vocab_size, (b, SEQ)),
               labels=rng.integers(0, cfg.vocab_size, (b, SEQ)))
    out["labels"][0, :3] = -1
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.normal(0, 1, (b, ENC_FRAMES, cfg.d_model)) \
            .astype(jnp.bfloat16).astype(np.float32)
    if cfg.qkv_bias:
        for k, shape in (("bq", (cfg.padded_heads, cfg.head_dim_)),
                         ("bk", (cfg.num_kv_heads, cfg.head_dim_)),
                         ("bv", (cfg.num_kv_heads, cfg.head_dim_))):
            out[k] = rng.normal(0, 0.5, (cfg.num_layers,) + shape)
    return {k: v.astype(np.int32) if v.dtype == np.int64 else
            v.astype(np.float32) for k, v in out.items()}


def f9_inputs() -> dict:
    cfg = T.reduced(T.get_arch("mamba2-780m"))
    rng = np.random.default_rng(49)
    return {k: rng.integers(0, cfg.vocab_size, (1, F9_SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def first_step_cfg(opt_cfg):
    """`opt_cfg` with the warmup cut to one step, so that the first step
    takes the full rate (3e-4, not 3e-6): an update that moves bf16
    parameters and stands far above float32 rounding."""
    return dataclasses.replace(opt_cfg, warmup_steps=1)


def _jbatch(ins: dict) -> dict:
    return {k: jnp.asarray(ins[k], jnp.bfloat16 if k == "enc_embeds"
                           else jnp.int32)
            for k in ("tokens", "labels", "enc_embeds") if k in ins}


def _store(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def draw_params(name: str, jcfg) -> dict:
    """Numpy weights of `jcfg` by the reference's init rules (zeros, ones,
    normal x 0.02, normal x fan_in**-0.5) from a seed, in its
    `param_dtype` (bf16 draws as float32 arrays of bf16 values); qwen's
    qkv biases from `inputs_of`."""
    rng = np.random.default_rng(60 + ARCHS.index(name))
    ins = inputs_of(name)

    def one(path, spec):
        if spec.init in ("zeros", "ones"):
            x = np.full(spec.shape, spec.init == "ones", np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            scale = 0.02 if spec.init == "small" else fan_in ** -0.5
            x = (rng.normal(0, 1, spec.shape) * scale).astype(np.float32)
        if jcfg.param_dtype == "bfloat16":
            x = x.astype(jnp.bfloat16).astype(np.float32)
        return x
    flat = {path: one(path, spec) for path, spec in _spec_items(
        JModel(jcfg).specs())}
    if jcfg.qkv_bias:
        for k in ("bq", "bk", "bv"):
            flat[f"layers.attn.{k}"] = ins[k]
    return flat


def _spec_items(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _spec_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def nest(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *parents, last = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _jparams(flat: dict, jcfg):
    dt = jnp.bfloat16 if jcfg.param_dtype == "bfloat16" else jnp.float32
    return jax.tree.map(lambda x: jnp.asarray(x, dt), nest(flat))


def write_reference(path: str) -> None:
    """Per arch and under float32 and bf16 compute, one jitted
    `make_train_step` from the optimizer's `init` on `draw_params`: the
    params and the optimizer state's leaves after it (in
    `jax.tree.leaves` order) and its metrics. F9: the reduced mamba2's
    float32 loss, logits and gradient at SSD chunks of 256 and 16. bf16
    values are stored as float32. The functions are traced in turn and
    compiled on two threads meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = []                      # (key prefix, lowered, args, unpack)
    for name in ARCHS:
        ins = inputs_of(name)
        for dtype in ("float32", "bfloat16"):
            jcfg, _ = cfgs(name, dtype)
            params = _jparams(draw_params(name, jcfg), jcfg)
            opt_cfg = first_step_cfg(JST.make_opt_cfg(jcfg))
            state = JST._opt_module(jcfg).init(params, opt_cfg)
            args = (params, state, _jbatch(ins))
            fn = jax.jit(JST.make_train_step(JModel(jcfg), opt_cfg, None))
            jobs.append((f"{name}/{dtype}", fn.lower(*args), args))

    f9 = f9_inputs()
    for chunk in (F9_CHUNK, F9_SMALL_CHUNK):
        jcfg, _ = cfgs("mamba2-780m", "float32", ssm_chunk=chunk)
        model = JModel(jcfg)

        def run(p, b, model=model):
            loss, grads = jax.value_and_grad(model.loss)(p, b)
            return loss, grads, model.forward(p, b)[0]
        args = (_jparams(f9_params(), jcfg), _jbatch(f9))
        jobs.append((f"f9/{chunk}", jax.jit(run).lower(*args), args))

    out = {}
    with ThreadPoolExecutor(2) as pool:
        compiled = [pool.submit(lowered.compile)
                    for _, lowered, _ in jobs]
        for (key, _, args), c in zip(jobs, compiled):
            res = c.result()(*args)
            if key.startswith("f9/"):
                loss, grads, logits = res
                out[f"{key}/loss"] = _store(loss)
                out[f"{key}/logits"] = _store(logits)
                out.update({f"{key}/grads/{k}": _store(v)
                            for k, v in _leaf_items(grads)})
                continue
            p2, s2, metrics = res
            out.update({f"{key}/params/{k}": _store(v)
                        for k, v in _leaf_items(p2)})
            out.update({f"{key}/state/{i}": _store(v)
                        for i, v in enumerate(jax.tree.leaves(s2))})
            out.update({f"{key}/{k}": _store(v) for k, v in metrics.items()})
    np.savez(path, **out)


def f9_params() -> dict:
    jcfg, _ = cfgs("mamba2-780m", "float32")
    return draw_params("mamba2-780m", jcfg)


def start_reference(d: pathlib.Path) -> subprocess.Popen:
    """The reference's subprocess (module docstring), writing
    d/reference.npz and its errors to d/stderr.txt."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + f" {REF_XLA_FLAGS} {FAST_XLA_FLAGS}"
        f" {ONE_THREAD_XLA_FLAGS}").strip())
    with open(d / "stderr.txt", "w") as err:
        return subprocess.Popen([sys.executable, __file__,
                                 str(d / "reference.npz")],
                                stdout=subprocess.DEVNULL, stderr=err,
                                env=env)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """Start the reference's subprocess when the module's first test
    starts, so that it runs beside the tests that do not need it; `refs`
    waits for it."""
    d = tmp_path_factory.mktemp("lm_train")
    proc = start_reference(d)
    threads = torch.get_num_threads()
    # The subprocess compiles on two threads meanwhile; torch's spinning
    # intra-op threads would contend with it.
    torch.set_num_threads(min(threads, 2))
    yield proc, d
    torch.set_num_threads(threads)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def refs(reference_run):
    """The reference's outputs."""
    proc, d = reference_run
    rc = proc.wait(timeout=600)
    assert rc == 0, (d / "stderr.txt").read_text()[-4000:]
    data_ = np.load(d / "reference.npz")
    return {k: data_[k] for k in data_.files}


# ---------------------------------------------------------------------------
# Optimizers and compression
# ---------------------------------------------------------------------------

def assert_ulp(got, want, label: str, bf16: bool = False, n: float = 1,
               of_leaf: bool = False) -> None:
    """Each element within `n` ulps (of float32, or of bf16 with `bf16`)
    of the larger magnitude of the two, or with `of_leaf` of the leaf's
    largest magnitude."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, label
    mag = np.maximum(np.abs(got), np.abs(want))
    if of_leaf:
        mag = np.full_like(mag, mag.max(initial=0))
    if bf16:
        e = np.floor(np.log2(np.where(mag > 0, mag, 1)))
        ulp = np.where(mag > 0, 2.0 ** (e - 7), 0)
    else:
        ulp = np.spacing(mag)
    bad = np.abs(got - want) > n * ulp
    assert not bad.any(), (label, int(bad.sum()),
                           float(np.abs(got - want).max()))


def _tt(tree, dtype=None):
    """numpy tree -> torch tree (leaves cast to `dtype`)."""
    return jax.tree.map(lambda x: torch.from_numpy(np.asarray(
        x, np.float32)).to(dtype or torch.float32), tree)


def _jt(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def test_optimizers_and_lr_match_reference():
    """`adamw.apply` (float32 and bf16 moments, clipped and unclipped
    gradients, steps 1 and 8) and `adafactor.apply` (factored, batched
    factored and unfactored leaves, float32 and bf16 parameters, zero and
    nonzero moments, with and without weight decay) against the
    reference's eager `apply` on the same numpy trees, and `lr_at` over
    steps 0-100 (warmup and cosine).

    `lr_at` is within one float32 ulp of the peak rate (its cosine differs
    from XLA's by an ulp, which 1 + cos magnifies near the end of the
    decay: measured 0.25 ulp of the peak). Where only elementwise
    arithmetic decides a value, it is within one ulp of its dtype: every
    AdamW leaf of an unclipped step,
    bf16 moments and bf16 Adafactor parameters (measured 0-1 ulp). A
    float32 reduction sums in another order than XLA's, so where one
    enters (the global norm and AdamW's clip scale; Adafactor's row,
    column and RMS means) the limits are about twice the measured
    spread: the grad norm rtol 2.5e-6 (measured 1.2e-6), clipped AdamW's
    parameters 1 ulp and moments 2 ulps of the leaf's largest magnitude
    (measured 1.0 and 1.0: one of them cancels to 1024 of its own
    ulps), float32 Adafactor's parameters 1 ulp and moments 4 ulps of the
    leaf's largest magnitude (measured 0.125 and 2.0)."""
    rng = np.random.default_rng(3)
    params = dict(w=rng.normal(0, 1, (48, 40)), b=rng.normal(0, 0.1, 40),
                  e=dict(t=rng.normal(0, 1, (3, 5, 7))))
    for gscale, step, mdt in ((1.0, 0, "float32"), (1e-3, 7, "float32"),
                              (1.0, 7, "bfloat16")):
        grads = jax.tree.map(lambda p: rng.normal(0, gscale, p.shape),
                             params)
        m = jax.tree.map(lambda p: rng.normal(0, 1e-2, p.shape), params)
        v = jax.tree.map(lambda p: rng.uniform(0, 1e-3, p.shape), params)
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if mdt == "bfloat16"
                    else (jnp.float32, torch.float32))
        jcfg = jadamw.AdamWConfig(moment_dtype=jdt, warmup_steps=5)
        tcfg = adamw.AdamWConfig(moment_dtype=tdt, warmup_steps=5)
        want = jadamw.apply(_jt(params), _jt(grads),
                            jadamw.OptState(_jt(m, jdt), _jt(v, jdt),
                                            jnp.asarray(step, jnp.int32)),
                            jcfg)
        got = adamw.apply(_tt(params), _tt(grads),
                          adamw.OptState(_tt(m, tdt), _tt(v, tdt),
                                         torch.tensor(step,
                                                      dtype=torch.int32)),
                          tcfg)
        label = f"adamw g{gscale} step {step} {mdt}"
        clipped = gscale == 1.0
        np.testing.assert_allclose(float(got[2]["grad_norm"]),
                                   float(want[2]["grad_norm"]), rtol=2.5e-6)
        assert (float(want[2]["grad_norm"]) > 1) == clipped
        assert_ulp(got[2]["lr"], want[2]["lr"], label)
        for x, y in zip(ckpt.flatten(got[0]), jax.tree.leaves(want[0])):
            assert_ulp(x, y, label + " params", of_leaf=clipped)
        for i in (0, 1):
            for x, y in zip(ckpt.flatten(got[1][i]),
                            jax.tree.leaves(want[1][i])):
                assert x.dtype == tdt
                if mdt == "bfloat16":
                    assert_ulp(x, y, label + " moment", bf16=True)
                else:
                    assert_ulp(x, y, label + " moment", n=2 if clipped else 1,
                               of_leaf=clipped)
        assert int(got[1].step) == int(want[1].step) == step + 1
        assert got[1].step.dtype == torch.int32

    params = dict(w=rng.normal(0, 1, (160, 130)),
                  w3=rng.normal(0, 1, (2, 130, 128)),
                  b=rng.normal(0, 1, 50), s=rng.normal(0, 1, (4, 200)))
    for pdt, step, nonzero, wd in (("float32", 0, False, 0.0),
                                   ("float32", 4, True, 0.1),
                                   ("bfloat16", 4, True, 0.0),
                                   ("bfloat16", 0, False, 0.1)):
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if pdt == "bfloat16"
                    else (jnp.float32, torch.float32))
        jcfg = jafactor.AdafactorConfig(weight_decay=wd, warmup_steps=5)
        tcfg = adafactor.AdafactorConfig(weight_decay=wd, warmup_steps=5)
        jp = _jt(params, jdt)
        jstate = jafactor.init(jp, jcfg)
        if nonzero:
            jstate = jstate._replace(v=jax.tree.map(
                lambda x: jnp.asarray(rng.uniform(0.1, 2.0, x.shape),
                                      jnp.float32), jstate.v))
        jstate = jstate._replace(step=jnp.asarray(step, jnp.int32))
        grads = jax.tree.map(lambda p: rng.normal(0, 1e-2, p.shape),
                             params)
        want = jafactor.apply(jp, _jt(grads, jdt), jstate, jcfg)
        tstate = convert.lm_opt_state_from_numpy(
            jax.tree.map(np.asarray, jstate))
        zeros = adafactor.init(_tt(params, tdt), tcfg)
        assert [tuple(x.shape) for x in ckpt.flatten(zeros)] == \
            [tuple(x.shape) for x in jax.tree.leaves(jstate)]
        got = adafactor.apply(_tt(params, tdt), _tt(grads, tdt), tstate,
                              tcfg)
        label = f"adafactor {pdt} step {step} wd {wd}"
        np.testing.assert_allclose(float(got[2]["grad_norm"]),
                                   float(want[2]["grad_norm"]), rtol=2.5e-6)
        assert_ulp(got[2]["lr"], want[2]["lr"], label)
        for x, y in zip(ckpt.flatten(got[0]), jax.tree.leaves(want[0])):
            assert x.dtype == tdt
            if pdt == "bfloat16":
                assert_ulp(x, y, label + " params", bf16=True)
            else:
                assert_ulp(x, y, label + " params", of_leaf=True)
        for x, y in zip(ckpt.flatten(got[1]), jax.tree.leaves(want[1])):
            assert_ulp(x, y, label + " moments", n=4, of_leaf=True)

    for jcfg, tcfg in ((jadamw.AdamWConfig(lr=1.0, warmup_steps=10,
                                           total_steps=100),
                        adamw.AdamWConfig(lr=1.0, warmup_steps=10,
                                          total_steps=100)),
                       (jadamw.AdamWConfig(), adamw.AdamWConfig())):
        for step in range(101):
            got = float(adamw.lr_at(torch.tensor(step, dtype=torch.int32),
                                    tcfg))
            want = float(jadamw.lr_at(jnp.asarray(step, jnp.int32), jcfg))
            assert abs(got - want) <= np.spacing(np.float32(tcfg.lr)), step


def test_optimizers_converge_on_quadratic():
    """Both optimizers converge on `test_substrate.py`'s quadratic (with a
    256 x 256 leaf that Adafactor factors), gradients by autograd."""
    target = torch.tensor([1.5, -2.0, 0.5])
    for opt, cfg, atol in (
            (adamw, adamw.AdamWConfig(lr=5e-2, weight_decay=0.0,
                                      warmup_steps=10, total_steps=200),
             0.05),
            (adafactor, adafactor.AdafactorConfig(lr=1e-1, warmup_steps=10,
                                                  total_steps=200), 0.1)):
        params = dict(w=torch.zeros(3), m=torch.zeros(256, 256))
        state = opt.init(params, cfg)
        for _ in range(200):
            leaves = [p.requires_grad_(True) for p in ckpt.flatten(params)]
            tree = ckpt.unflatten(params, leaves)
            loss = torch.sum((tree["w"] - target) ** 2) \
                + 1e-4 * torch.sum(tree["m"] ** 2)
            grads = ckpt.unflatten(params, list(torch.autograd.grad(
                loss, leaves)))
            with torch.no_grad():
                params, state, _ = opt.apply(params, grads, state, cfg)
        np.testing.assert_allclose(params["w"].detach().numpy(),
                                   target.numpy(), atol=atol)


def test_compression_matches_reference():
    """`compress_decompress` under none, topk (with a tie at the
    threshold) and int8 (with exact .5 quotients) over four rounds of
    error feedback, and `apply_tree` / `init_residuals`: every
    transmitted gradient and residual exactly the reference's."""
    rng = np.random.default_rng(4)
    g = rng.normal(0, 1, (64, 64)).astype(np.float32)
    g[0, :3] = 4.0                       # ties at the top-k threshold
    g[1, 0], g[1, 1] = -6.35, 3.175      # 127 x scale / 2 quotients
    small = rng.normal(0, 1, 7).astype(np.float32)
    for kind in ("none", "topk", "int8"):
        jcfg = jcomp.CompressionConfig(kind=kind, topk_frac=0.05)
        tcfg = compression.CompressionConfig(kind=kind, topk_frac=0.05)
        for x in (g, small):
            jr, tr = jnp.zeros_like(x), torch.zeros(x.shape)
            for r in range(4):
                xi = x * (1 + 0.1 * r)
                jh, jr = jcomp.compress_decompress(jnp.asarray(xi), jr, jcfg)
                th, tr = compression.compress_decompress(
                    torch.from_numpy(xi), tr, tcfg)
                np.testing.assert_array_equal(th.numpy(), np.asarray(jh),
                                              err_msg=f"{kind} round {r}")
                np.testing.assert_array_equal(tr.numpy(), np.asarray(jr),
                                              err_msg=f"{kind} round {r}")
        tree = dict(a=g, b=dict(c=small))
        jh, jres = jcomp.apply_tree(_jt(tree), jcomp.init_residuals(
            _jt(tree)), jcfg)
        th, tres = compression.apply_tree(
            _tt(tree), compression.init_residuals(_tt(tree)), tcfg)
        for x, y in zip(ckpt.flatten((th, tres)), jax.tree.leaves((jh,
                                                                   jres))):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    with pytest.raises(ValueError):
        compression.compress_decompress(
            torch.zeros(3), torch.zeros(3),
            compression.CompressionConfig(kind="fp4"))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_synthetic_batch_contract_and_host_slice():
    """`synthetic_batch` holds the reference's contract for the dense,
    embeds-input and enc-dec families: the reference's keys and shapes
    (int64 ids, bf16 embeddings), ids in the vocabulary, deterministic in
    (seed, step) and different across steps and seeds; dense labels are
    the tokens shifted by one from one draw, enc-dec labels the decoder
    tokens shifted with -1 last. `host_slice` partitions the batch as the
    reference's does."""
    from repro.data import tokens as jdata

    shape = ShapeConfig("custom", "train", 12, 4)
    for name in ("qwen1.5-0.5b", "llava-next-mistral-7b",
                 "seamless-m4t-large-v2"):
        tcfg = T.reduced(T.get_arch(name))
        want = jdata.synthetic_batch(R.reduced(R.get_arch(name)), shape, 3)
        b = data.synthetic_batch(tcfg, shape, 3)
        assert b.keys() == want.keys(), name
        for k, v in b.items():
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert v.dtype == (torch.bfloat16 if "embeds" in k
                               else torch.int64), (name, k)
        again = data.synthetic_batch(tcfg, shape, 3)
        assert all(torch.equal(b[k], again[k]) for k in b)
        for other in (data.synthetic_batch(tcfg, shape, 4),
                      data.synthetic_batch(tcfg, shape, 3, seed=1)):
            assert all(not torch.equal(b[k], other[k]) for k in b), name
        labels = b["labels"]
        if tcfg.family == "encdec":
            toks = b["tokens"]
            assert torch.equal(labels[:, :-1], toks[:, 1:])
            assert bool((labels[:, -1] == -1).all())
        elif "tokens" in b:
            assert torch.equal(labels[:, :-1], b["tokens"][:, 1:])
        if "tokens" in b:
            assert 0 <= int(b["tokens"].min()) and \
                int(b["tokens"].max()) < tcfg.vocab_size
        assert int(labels.max()) < tcfg.vocab_size
        for world in (1, 2, 4):
            parts = [data.host_slice(b, r, world) for r in range(world)]
            jparts = [jdata.host_slice({k: v.float().numpy()
                                        for k, v in b.items()}, r, world)
                      for r in range(world)]
            for k in b:
                assert torch.equal(torch.cat([p[k] for p in parts]), b[k])
                for p, q in zip(parts, jparts):
                    np.testing.assert_array_equal(p[k].float().numpy(),
                                                  q[k])


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

def test_remat_changes_no_bit(monkeypatch):
    """For every family of the train-step test under bf16 compute, the
    loss and every gradient with the blocks checkpointed (the default)
    are bit-equal to those with `blocks.checkpoint` replaced by a plain
    call, through which the checkpointed run went."""
    calls = []

    def plain(fn, *args, use_reentrant):
        calls.append(fn)
        return fn(*args)
    for name in ARCHS:
        _, tcfg = cfgs(name, "bfloat16")
        m = Model(tcfg, device="cpu", seed=1)
        m.requires_grad_(True)
        ins = inputs_of(name)
        batch = convert.lm_batch_from_numpy(
            {k: ins[k] for k in ("tokens", "labels", "enc_embeds")
             if k in ins})
        out = []
        for remat in (True, False):
            with monkeypatch.context() as mp:
                if not remat:
                    mp.setattr(B, "checkpoint", plain)
                loss = m.loss(batch)
                out.append((loss, torch.autograd.grad(
                    loss, list(m.parameters()))))
        assert calls, name
        calls.clear()
        (l1, g1), (l2, g2) = out
        assert torch.equal(l1, l2), name
        assert all(torch.equal(a, b) for a, b in zip(g1, g2)), name


# ---------------------------------------------------------------------------
# Driver, checkpoints, imports
# ---------------------------------------------------------------------------

class PreemptAt(TR.FaultManager):
    """A FaultManager that takes a preemption notice at step `at` (its
    SIGTERM handler called directly, no signal sent)."""

    def __init__(self, cfg, at: int):
        super().__init__(dataclasses.replace(cfg, install_sigterm_hook=False))
        self.at = at

    def maybe_save(self, step, tree):
        if step == self.at:
            self._on_sigterm(15, None)
        return super().maybe_save(step, tree)


def test_train_driver_resumes_bit_equal(tmp_path, capsys):
    """`launch.train`: the reference's CLI test (reduced mamba2, 4 steps
    saving every 2, then a restart to 6 that resumes from step 4) returns
    0; a 6-step run preempted after step 4 and restarted ends bit-equal
    (parameters and optimizer state) to 6 uninterrupted steps;
    `--compress int8` on reduced qwen returns 0; `--device cuda` exits 2
    without a card; `--production-mesh` raises ValueError with the device
    count (256 needed)."""
    base = ["--device", "cpu", "--arch", "mamba2-780m", "--reduced",
            "--batch", "2", "--seq", "32", "--save-every", "2"]
    ck = str(tmp_path / "ck")
    assert TR.main(base + ["--steps", "4", "--ckpt-dir", ck]) == 0
    assert TR.main(base + ["--steps", "6", "--ckpt-dir", ck]) == 0
    assert "restored checkpoint at step 4" in capsys.readouterr().out

    args = TR.parser().parse_args(base + ["--steps", "6", "--ckpt-dir",
                                          str(tmp_path / "pre")])
    fm = PreemptAt(TR.FaultConfig(ckpt_dir=args.ckpt_dir, save_every=2), 4)
    first = TR.run(args, log=lambda m: None, fault_manager=fm)
    assert first["stopped"] and len(first["metrics"]) == 4
    resumed = TR.run(args, log=lambda m: None)
    assert resumed["start"] == 4 and len(resumed["metrics"]) == 2
    whole = TR.run(TR.parser().parse_args(
        base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "whole")]),
        log=lambda m: None)
    for a, b in zip(resumed["model"].state_dict().values(),
                    whole["model"].state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(ckpt.flatten(resumed["opt_state"]),
                    ckpt.flatten(whole["opt_state"])):
        assert torch.equal(a, b)
    assert resumed["metrics"] == whole["metrics"][4:]
    assert all(np.isfinite(v) for m in whole["metrics"] for v in m.values())

    assert TR.main(["--device", "cpu", "--arch", "qwen1.5-0.5b", "--reduced",
                    "--steps", "3", "--batch", "2", "--seq", "32",
                    "--compress", "int8", "--ckpt-dir",
                    str(tmp_path / "ck2"), "--save-every", "100"]) == 0
    if not torch.cuda.is_available():
        assert TR.main(["--arch", "qwen1.5-0.5b", "--reduced"]) == 2
        assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs 256 devices"):
        TR.main(base + ["--production-mesh"])


def test_lm_checkpoints_cross_packages(tmp_path):
    """(params, optimizer state) checkpoints written by either package
    restore in the other bit for bit: reduced qwen with AdamW (float32)
    and reduced arctic with Adafactor (bf16 parameters, written as their
    16 bits). `convert.lm_opt_state_from_numpy` / `_to_numpy` carry both
    states in `jax.tree.leaves` order."""
    for name in ("qwen1.5-0.5b", "arctic-480b"):
        jcfg, tcfg = cfgs(name, "float32")
        m, state, _ = port_step_of(name, "float32")
        jparams = _jparams(draw_params(name, jcfg), jcfg)
        jopt = JST._opt_module(jcfg)
        jstate = jopt.init(jparams, JST.make_opt_cfg(jcfg))
        d = str(tmp_path / name)
        ckpt.save(d, 3, (m.params(), state))
        back = jckpt.restore(d, 3, (jparams, jstate))
        port_leaves = ckpt.flatten((m.params(), state))
        assert len(port_leaves) == len(jax.tree.leaves(back))
        for x, y in zip(port_leaves, jax.tree.leaves(back)):
            x = x.detach()
            want = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            assert np.asarray(y).tobytes() == want.numpy().tobytes()

        jstate = jstate._replace(step=jnp.asarray(5, jnp.int32))
        jckpt.save(d, 5, (jparams, jstate))
        fresh = Model(tcfg, device="cpu", seed=3)
        tstate = ST._opt_module(tcfg).init(fresh.params(),
                                           ST.make_opt_cfg(tcfg))
        params, tstate = ckpt.restore(d, 5, (fresh.params(), tstate))
        for x, y in zip(ckpt.flatten((params, tstate)),
                        jax.tree.leaves((jparams, jstate))):
            x, y = x.detach(), np.asarray(y)
            assert x.dtype == {np.dtype(np.float32): torch.float32,
                               np.dtype(np.int32): torch.int32}.get(
                y.dtype, torch.bfloat16)
            got = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
            assert got.numpy().tobytes() == y.tobytes()

        npy = jax.tree.map(np.asarray, jstate)
        conv = convert.lm_opt_state_from_numpy(npy)
        assert type(conv).__name__ == type(jstate).__name__
        for x, y in zip(ckpt.flatten(conv), jax.tree.leaves(npy)):
            np.testing.assert_array_equal(f32(x), f32(y))
        again = convert.lm_opt_state_from_numpy(
            convert.lm_opt_state_to_numpy(conv))
        for x, y in zip(ckpt.flatten(again), ckpt.flatten(conv)):
            assert torch.equal(x, y)


def test_lm_train_modules_import_without_jax(tmp_path):
    """optim/, data/, launch.steps and launch.train import and train
    reduced qwen for two steps with top-k compression through the driver
    with `jax` and `repro` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "import repro_torch.optim, repro_torch.data\n"
        "from repro_torch.launch import steps, train\n"
        f"rc = train.main(['--device', 'cpu', '--arch', 'qwen1.5-0.5b', "
        f"'--reduced', '--steps', '2', '--batch', '2', '--seq', '16', "
        f"'--compress', 'topk', '--save-every', '1', '--ckpt-dir', "
        f"{str(tmp_path / 'ck')!r}])\n"
        "assert rc == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


# Tests that read the reference's subprocess run last, so that it runs
# beside the tests above.
# ---------------------------------------------------------------------------
# Train step, per family
# ---------------------------------------------------------------------------

def port_step_of(name: str, dtype: str):
    """The port's reduced `name` on the reference's weights, its optimizer
    state from `init`, one train step on the reference's batch: (model,
    state, metrics)."""
    jcfg, tcfg = cfgs(name, dtype)
    m = Model(tcfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(nest(draw_params(name,
                                                                    jcfg))))
    opt_cfg = first_step_cfg(ST.make_opt_cfg(tcfg))
    state = ST._opt_module(tcfg).init(m.params(), opt_cfg)
    ins = inputs_of(name)
    batch = convert.lm_batch_from_numpy(
        {k: ins[k] for k in ("tokens", "labels", "enc_embeds") if k in ins})
    state, metrics = ST.make_train_step(m, opt_cfg)(state, batch)
    return m, state, metrics


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element's magnitude (that of 1 at 0)."""
    mag = np.abs(x)
    return 2.0 ** (np.floor(np.log2(np.where(mag > 0, mag, 1))) - 7)


def hold_update(label: str, before, got, want, lr: float,
                bf16_compute: bool, g=None, g32=None) -> tuple:
    """One parameter's update, the port's (`got - before`) against the
    reference's (`want - before`), at the module docstring's tolerances.
    AdamW (`g`, the reference's gradient; `g32`, its float32-compute one
    under bf16 compute): on every element whose gradient stands clear of
    rounding, within 1e-3 lr plus the two float32 roundings of the
    parameter. Adafactor's bf16 parameters (no `g`): the port moves the
    leaves the reference moves, some by two bf16 ulps or more, and lands
    within one ulp of the reference (bf16 compute: the same direction on
    at least 98% of the elements the reference moved that far). Returns
    what was measured: (kind, value)."""
    d_got, d_want = got - before, want - before
    if g is None:
        far = np.abs(d_want) >= 2 * bf16_ulp(before)
        assert (d_got != 0).any() == (d_want != 0).any() == far.any(), label
        if not bf16_compute:
            assert_ulp(got, want, label, bf16=True)
            mag = np.maximum(np.abs(got), np.abs(want))
            return "bf16 ulps", float((np.abs(got - want)
                                       / bf16_ulp(mag)).max())
        same = np.mean(np.sign(d_got[far]) == np.sign(d_want[far])) \
            if far.any() else 1.0
        assert same >= 0.98, (label, same)
        return "direction kept", float(same)
    if not bf16_compute:
        clear = np.abs(g) > 1e-2 * np.abs(g).max()
    else:
        clear = (np.abs(g) > 0.1 * np.abs(g).max()) & \
            (np.sign(g) == np.sign(g32))
    assert clear.any() and (d_got != 0).any(), label
    err = np.abs(d_got - d_want)[clear]
    ulps = 2 * np.spacing(np.abs(before[clear]))
    assert (err <= 1e-3 * lr + ulps).all(), (label, float(err.max()) / lr)
    return "update / lr past two ulps", float(np.max(err - ulps)) / lr


def hold_step(refs: dict, name: str, dtype: str) -> dict:
    """Loss, grad norm, lr, every parameter's update and every
    optimizer-state leaf after one step against the reference's, at the
    module docstring's tolerances. Returns the parameters' spreads, the
    worst of each kind (`hold_update`)."""
    jcfg, _ = cfgs(name, dtype)
    m, state, metrics = port_step_of(name, dtype)
    pre, pre32 = f"{name}/{dtype}", f"{name}/float32"
    bf16_params = m.cfg.param_dtype == "bfloat16"
    lr = float(metrics["lr"])
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(
            float(metrics[k]), float(refs[f"{pre}/{k}"]),
            rtol=1e-4 if dtype == "float32" else 1e-2, err_msg=f"{pre} {k}")
    got = m.state_dict()
    spreads = {}
    # The state's leaves start with AdamW's first moments, (1 - b1) g, in
    # the parameters' order (`draw_params` keeps the reference's).
    for i, (k, before) in enumerate(draw_params(name, jcfg).items()):
        g = g32 = None
        if not bf16_params:
            g, g32 = refs[f"{pre}/state/{i}"], refs[f"{pre32}/state/{i}"]
        assert np.isfinite(f32(got[k])).all(), (pre, k)
        kind, value = hold_update(f"{pre} {k}", before, f32(got[k]),
                                  f32(refs[f"{pre}/params/{k}"]), lr,
                                  dtype == "bfloat16", g, g32)
        worst = min if kind == "direction kept" else max
        spreads[kind] = worst(spreads.get(kind, value), value)
    leaves = ckpt.flatten(state)
    n = sum(1 for k in refs if k.startswith(f"{pre}/state/"))
    assert len(leaves) == n, pre
    for i, t in enumerate(leaves[:-1]):
        got, want = f32(t), f32(refs[f"{pre}/state/{i}"])
        label = f"{pre} state {i}"
        assert got.shape == want.shape and np.isfinite(got).all(), label
        scale = max(float(np.abs(want).max()), 1e-30)
        if dtype == "float32":
            limit = 2.5e-2 if bf16_params else 1e-4
            assert float(np.abs(got - want).max()) <= limit * scale, label
            continue
        assert rel_rms(got, want) <= 0.1, (label, rel_rms(got, want))
        want32 = f32(refs[f"{pre32}/state/{i}"])
        if np.abs(want32).max() > 0:
            assert rel_rms(got, want32) <= 1.5 * rel_rms(want, want32), label
    assert int(leaves[-1]) == int(refs[f"{pre}/state/{n - 1}"]) == 1
    return spreads


def test_train_step_matches_reference_float32(refs):
    """One `make_train_step` per family under float32 compute (qwen with 2
    microbatches, deepseek and zamba2 with 4, arctic's Adafactor with 16
    accumulated in bf16 on bf16 parameters): loss, grad norm, lr and the
    moments within 1e-4 of each leaf's max |value|, each parameter's
    update within 1e-3 lr where its gradient stands clear of rounding;
    arctic's bf16 parameters within one bf16 ulp and its moments, the
    squares of gradients rounded to bf16 and summed in bf16, within
    2.5e-2 of each leaf's max (module docstring). The prefill and decode
    steps serve the trained model: `Model.prefill`, and a greedy
    `decode_step`."""
    for name in ARCHS:
        hold_step(refs, name, "float32")
    m, _, _ = port_step_of("qwen1.5-0.5b", "float32")
    batch = dict(tokens=torch.arange(6).reshape(2, 3))
    logits, caches = ST.make_prefill_step(m)(batch)
    want_logits, _ = m.prefill(batch)
    assert torch.equal(logits, want_logits)
    want, _ = m.decode_step(m.init_caches(2, 4), batch["tokens"][:, :1])
    tok, caches = ST.make_decode_step(m)(m.init_caches(2, 4),
                                         batch["tokens"][:, :1])
    assert tok.dtype == torch.int64 and caches["pos"] == 1
    assert torch.equal(tok[:, 0], torch.argmax(want, -1))


def test_train_step_matches_reference_bf16(refs):
    """The same steps under bf16 compute (module docstring): loss, grad
    norm and lr within rtol 1e-2; each parameter's update within 1e-3 lr
    where the reference's gradient is large and has its float32 sign
    (arctic's: the reference's direction on at least 98% of the elements
    it moved two ulps or more); each moment within relative RMS 0.1 of
    the reference's and at most 1.5x as far from the reference's float32
    step as the reference's bf16 one."""
    for name in ARCHS:
        hold_step(refs, name, "bfloat16")


# ---------------------------------------------------------------------------
# F9: finite SSD gradients at a full chunk
# ---------------------------------------------------------------------------

def _before_f9(decay, mask):
    """The reference's intra-chunk weight, `where(mask, exp(decay), 0)`."""
    return torch.where(mask, torch.exp(decay), 0.0)


def test_ssd_gradient_is_finite_at_a_full_chunk(refs, monkeypatch):
    """F9 on reduced mamba2 (2 layers, d_model 64, float32) at one SSD
    chunk of 256 tokens: the sums of dt over a chunk pass 88.7, so above
    the diagonal `exp(decay)` overflows. The reference's gradient is
    non-finite there (every entry of `a_log`, `dt_bias`, `dt_proj` and
    `ln`, one layer of the other mixer leaves), and so is the port's with
    the reference's weight. The port's logits and loss are bit-equal to
    those with the reference's weight and within `test_torch_lm_families`'
    float32 tolerance of the reference's; every gradient leaf is finite
    and within 4e-5 of each leaf's max |value| of the reference's
    gradient at a chunk of 16, where the reference stays finite (measured
    1.6e-5: the two chunkings sum in different orders)."""
    bad = [k for k in refs if k.startswith(f"f9/{F9_CHUNK}/grads/")
           and not np.isfinite(refs[k]).all()]
    assert {"layers.mixer.a_log", "layers.mixer.dt_bias",
            "layers.mixer.dt_proj", "layers.ln"} <= \
        {k.split("/")[-1] for k in bad}, bad
    assert all(np.isfinite(refs[k]).all() for k in refs
               if k.startswith(f"f9/{F9_SMALL_CHUNK}/grads/"))

    jcfg, tcfg = cfgs("mamba2-780m", "float32", ssm_chunk=F9_CHUNK)
    m = Model(tcfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(nest(f9_params())))
    m.requires_grad_(True)
    batch = convert.lm_batch_from_numpy(f9_inputs())
    names = [k for k, _ in m.named_parameters()]

    def run():
        loss = m.loss(batch)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        return loss.detach(), dict(zip(names, grads)), m.forward(batch)[0]

    loss, grads, logits = run()
    with monkeypatch.context() as mp:
        mp.setattr(S, "intra_chunk_weight", _before_f9)
        loss0, grads0, logits0 = run()
    assert torch.equal(logits, logits0) and torch.equal(loss, loss0)
    assert not all(bool(torch.isfinite(g).all()) for g in grads0.values())
    want = f32(refs[f"f9/{F9_CHUNK}/logits"])
    np.testing.assert_allclose(f32(logits), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(loss), float(refs[f"f9/{F9_CHUNK}/loss"]),
                               rtol=1e-4)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        want = f32(refs[f"f9/{F9_SMALL_CHUNK}/grads/{k}"])
        np.testing.assert_allclose(f32(g), want, rtol=0,
                                   atol=4e-5 * np.abs(want).max(),
                                   err_msg=k)


def print_spreads() -> None:
    """`python tests/test_torch_lm_train.py --spreads`: each family's
    parameter spreads against the reference, as `hold_step` measures them
    (the module docstring's figures; about a minute)."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        d = pathlib.Path(d)
        assert start_reference(d).wait() == 0, \
            (d / "stderr.txt").read_text()[-4000:]
        data_ = np.load(d / "reference.npz")
        refs = {k: data_[k] for k in data_.files}
    for name in ARCHS:
        for dtype in ("float32", "bfloat16"):
            print(name, dtype, hold_step(refs, name, dtype), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--spreads":
        print_spreads()
    else:
        write_reference(sys.argv[1])
