"""The port's LM serving path for the MoE/MLA, SSM, hybrid and enc-dec
families (`repro_torch.models.moe`, `mla`, `mamba2`, the family branches
of `blocks` and `model`) against the JAX reference's library path
(`repro.models.model.Model` with mesh=None) on the CPU.

Archs: arctic-480b (MoE, GQA, dense residual, bf16 parameters),
deepseek-v2-lite-16b (MoE with MLA, shared experts, a first dense layer),
mamba2-780m (SSM), zamba2-1.2b (hybrid; 5 layers here, so two groups
share the attention block and one layer is a tail) and
seamless-m4t-large-v2 (enc-dec). Configs are `reduced` with `attn_chunk`
and `ssm_chunk` 8. Weights are the reference's `Model.init(PRNGKey(0))`
carried across with `convert.lm_params_from_numpy`; inputs come from
numpy seeds. Prompts fit the reference's asserts: 16 tokens for the SSM
and hybrid (a multiple of the chunk), 20 for the attention families (not
a chunk multiple; B·S = 40 is within the reduced `moe_group` of 64) with
12 encoder frames for the enc-dec.

The reference's model outputs come from one subprocess whose XLA keeps
every bf16 rounding its code writes (`--xla_allow_excess_precision=
false`, as `test_torch_lm.py` explains; LLVM at -O0 to compile faster);
its layer functions (`moe_apply`, MLA, `ssd_chunked`, `mamba_decode`)
are jitted in this process under the same option.

Tolerances, and what an x86 CPU measured (worst over the five archs):

  float32 compute   forward and prefill logits within rtol 1e-4 and atol
                    1e-4 x max|logit| (measured 1.3e-5 x max|logit|), loss
                    rtol 1e-4. The MoE archs, whose decode state is only
                    attention or latent caches, as `test_torch_lm.py`
                    holds the dense family: decode logits within rtol
                    1e-4 / atol 1e-4 x max|logit| (measured 9.5e-7 x
                    max|logit|) and every cache within one bf16 ulp (rtol
                    2**-7). The archs that read back bf16 state they
                    wrote (an SSM state, the enc-dec's encoder output):
                    an f32 ulp between two exp or log1p implementations
                    flips a bf16 rounding of that state now and then, and
                    later steps carry it. Their limits are about twice
                    the worst measured: decode logits max |d| <= 3e-3 x
                    max|logit| and relative RMS <= 1.5e-3 (measured
                    1.1e-3 and 6.7e-4, the enc-dec), caches max |d| <=
                    1.5e-2 x max|x| and relative RMS <= 3e-3 (measured
                    7.1e-3, the hybrid's group state, and 1.5e-3, its
                    tail). The reference differs from itself by as much
                    between LLVM -O0 and -O3: decode logits up to 1.1e-3
                    x max|logit|, the hybrid's group state 7.1e-3 x max
  bf16 compute      logits relative RMS <= 1e-2, argmax agreement >= 0.95
                    and atol 0.08 / rtol 0.05 (measured 4.4e-3 and 0.975,
                    the enc-dec's forward), loss rtol 1e-2; caches
                    relative RMS <= 1e-2 (measured 5.6e-4)
  layer functions   float32 within 1e-5 of the output's scale, bf16
                    relative RMS <= 1e-2; expert choices and capacity
                    drops exact
  decode vs forward `test_archs.py`'s atol 0.08 / rtol 0.05 (MoE,
                    enc-dec) and 0.15 / 0.1 (SSM, hybrid)

The file holds 10 tests, so the tier-1 xdist queue starts it after
`test_stream_properties.py`. `python tests/test_torch_lm_families.py
OUT.npz` writes the reference's outputs.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.models import layers as JL
from repro.models import mamba2 as JS
from repro.models import mla as JM
from repro.models import moe as JE
from repro.models.model import Model as JModel

import repro_torch.configs as T
from repro_torch import convert
from repro_torch.models import mamba2 as S
from repro_torch.models import mla as M
from repro_torch.models import moe as E
from repro_torch.models.model import FAMILIES, Model, check_family
from repro_torch.models.pspec import leaves

from test_torch_lm import (REF_XLA_FLAGS, _leaf_items, f32, hold,
                           hold_cache, rel_rms)

ARCHS = ["arctic-480b", "deepseek-v2-lite-16b", "mamba2-780m",
         "zamba2-1.2b", "seamless-m4t-large-v2"]
DECODE = 8
ENC_FRAMES = 12
# LLVM at -O0 compiles the reference's jitted functions in 28 s, not 48;
# its results differ from -O3's by float32 ulps in the vectorized
# transcendentals (at most 7e-7 of max|logit| here).
FAST_XLA_FLAGS = "--xla_backend_optimization_level=0"


def cfgs(name: str, dtype: str, **extra):
    """(reference, port) reduced configs of `name`."""
    kw = dict(attn_chunk=8, ssm_chunk=8, dtype=dtype, **extra)
    if name == "zamba2-1.2b":
        kw.setdefault("num_layers", 5)
    return (dataclasses.replace(R.reduced(R.get_arch(name)), **kw),
            dataclasses.replace(T.reduced(T.get_arch(name)), **kw))


def prompt_len(cfg) -> int:
    return 16 if cfg.family in ("ssm", "hybrid") else 20


def inputs_of(name: str) -> dict:
    """The seeded numpy inputs of one arch: the prompt ("tokens", and
    bf16-valued "enc_embeds" for the enc-dec), "labels" with three
    masked and the 8 decode tokens."""
    cfg = T.reduced(T.get_arch(name))
    s = prompt_len(cfg)
    rng = np.random.default_rng(20 + ARCHS.index(name))
    out = dict(tokens=rng.integers(0, cfg.vocab_size, (2, s)),
               labels=rng.integers(0, cfg.vocab_size, (2, s)),
               dec_tokens=rng.integers(0, cfg.vocab_size, (2, DECODE)))
    out["labels"][0, :3] = -1
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.normal(0, 1, (2, ENC_FRAMES, cfg.d_model)) \
            .astype(jnp.bfloat16).astype(np.float32)
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in out.items()}


def write_reference(path: str) -> None:
    """Per arch: the params, and under float32 and bf16 compute, from one
    jitted function each, the forward logits and aux, the loss, prefill
    logits and caches, and 8 decode steps from fresh caches (the enc-dec's
    `enc_out` taken from its prefill) with the final caches. bf16 values
    are stored as float32 (exactly)."""
    out = {}
    for name in ARCHS:
        ins = inputs_of(name)
        jcfg, _ = cfgs(name, "float32")
        params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(
            jax.random.PRNGKey(0)))
        for k, v in _leaf_items(params):
            out[f"{name}/params/{k}"] = v
        batch = {k: jnp.asarray(ins[k], jnp.bfloat16 if k == "enc_embeds"
                                else jnp.int32)
                 for k in ("tokens", "enc_embeds") if k in ins}
        for dtype in ("float32", "bfloat16"):
            m = JModel(cfgs(name, dtype)[0])

            def run(p, x, labels, dec_tokens, m=m):
                res = {}
                res["logits"], res["aux"] = m.forward(p, x)
                # `Model.loss`'s body, on the forward above.
                res["loss"] = JL.softmax_xent(
                    res["logits"], labels, m.cfg.padded_vocab) \
                    + 0.01 * res["aux"]
                res["prefill_logits"], caches = m.prefill(p, x)
                res.update({f"prefill/{k}": v
                            for k, v in _leaf_items(caches)})
                c0 = m.init_caches(2, DECODE)
                if "enc_out" in c0:
                    c0["enc_out"] = caches["enc_out"].astype(jnp.bfloat16)

                def body(c, t):
                    lg, c = m.decode_step(p, c, t[:, None])
                    return c, lg
                c, res["steps"] = jax.lax.scan(body, c0, dec_tokens.T)
                res.update({f"cache/{k}": v for k, v in _leaf_items(c)})
                return res

            res = jax.jit(run)(params, batch, jnp.asarray(ins["labels"]),
                               jnp.asarray(ins["dec_tokens"]))
            out.update({f"{name}/{dtype}/{k}": v for k, v in res.items()})
    np.savez(path, **{k: np.asarray(v, np.float32)
                      if np.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
                      for k, v in out.items()})


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's outputs, from one subprocess (see the module
    docstring)."""
    path = tmp_path_factory.mktemp("lm_families") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + f" {REF_XLA_FLAGS} {FAST_XLA_FLAGS}"
    ).strip())
    res = subprocess.run([sys.executable, __file__, str(path)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    data = np.load(path)
    return {k: data[k] for k in data.files}


def param_tree(refs: dict, name: str) -> dict:
    tree: dict = {}
    prefix = f"{name}/params/"
    for k, v in refs.items():
        if k.startswith(prefix):
            node = tree
            *parents, last = k[len(prefix):].split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = v
    return tree


def port_model(refs: dict, name: str, dtype: str, **extra) -> Model:
    _, tcfg = cfgs(name, dtype, **extra)
    m = Model(tcfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(param_tree(refs, name)))
    return m


# Families whose decode reads back bf16 state it wrote (module docstring).
STATE_FAMILIES = ("ssm", "hybrid", "encdec")


def hold_state(got, want, dtype: str, family: str, label: str,
               logits: bool = False) -> None:
    """Float32 decode logits (`logits`) or a cache at the module's
    tolerance for `family`; under bf16 compute caches at relative RMS <=
    1e-2 and logits at `hold`'s."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, label
    if dtype != "float32" or family not in STATE_FAMILIES:
        (hold if logits else hold_cache)(got, want, dtype, label)
        return
    max_rel, rms = (3e-3, 1.5e-3) if logits else (1.5e-2, 3e-3)
    err = float(np.abs(got - want).max())
    assert err <= max_rel * float(np.abs(want).max()), (label, err)
    assert rel_rms(got, want) <= rms, (label, rel_rms(got, want))


def port_batch(ins: dict) -> dict:
    out = dict(tokens=torch.from_numpy(ins["tokens"]).long())
    if "enc_embeds" in ins:
        out["enc_embeds"] = torch.from_numpy(ins["enc_embeds"]).bfloat16()
    return out


def with_dtypes_of(ref_flat: dict, port_tree, prefix: str):
    """The reference's flat cache arrays under `prefix`, rebuilt into the
    port tree's nesting, each in its port leaf's dtype (bf16 as ml_dtypes
    bfloat16, which `convert` carries bit for bit)."""
    if isinstance(port_tree, dict):
        return {k: with_dtypes_of(ref_flat, v, f"{prefix}{k}.")
                for k, v in port_tree.items()}
    if isinstance(port_tree, tuple):
        return tuple(with_dtypes_of(ref_flat, v, f"{prefix}{i}.")
                     for i, v in enumerate(port_tree))
    x = ref_flat[prefix[:-1]]
    if not torch.is_tensor(port_tree):
        return x
    dt = {torch.bfloat16: jnp.bfloat16, torch.float32: np.float32,
          torch.int8: np.int8}[port_tree.dtype]
    return np.asarray(x).astype(dt)


# ---------------------------------------------------------------------------
# Spec trees and caches' layout
# ---------------------------------------------------------------------------

def test_spec_trees_cache_trees_and_draws_match_reference():
    """At full width on the meta device, every family's `state_dict` keys
    and shapes equal the reference's abstract parameter tree; all ten archs
    build, and only an unknown family is refused. At reduced size the
    decode caches' nesting, shapes and dtypes and `cache_logical` equal the
    reference's. Float32 leaves are drawn as before (one float32 `randn`
    each, in sorted-key order); bf16 leaves (arctic) are drawn in bf16 by
    the same rules."""
    for name in ARCHS:
        want = {"/".join(str(k.key) for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(
                    JModel(R.get_arch(name)).abstract())}
        m = Model(T.get_arch(name), device="meta")
        got = {k.replace(".", "/"): tuple(v.shape)
               for k, v in m.state_dict().items()}
        assert got == want, name
    for name in T.ARCHS:
        check_family(T.get_arch(name))
        assert T.get_arch(name).family in FAMILIES
    with pytest.raises(ValueError, match="unknown family"):
        Model(dataclasses.replace(T.reduced(T.get_arch("qwen1.5-0.5b")),
                                  family="rnn"), device="meta")

    jdt = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.int32): None}
    for name in ARCHS:
        jcfg, tcfg = cfgs(name, "bfloat16")
        want = JModel(jcfg).init_caches(2, 12)
        got = Model(tcfg, device="cpu").init_caches(2, 12)
        w_items, g_items = dict(_leaf_items(want)), dict(_leaf_items(got))
        assert w_items.keys() == g_items.keys(), name
        for k, w in w_items.items():
            if k == "pos":
                assert g_items[k] == int(w) == 0
                continue
            assert tuple(g_items[k].shape) == tuple(w.shape), (name, k)
            assert g_items[k].dtype == jdt[w.dtype], (name, k)
        assert Model(tcfg, device="meta").cache_logical(2) == \
            JModel(jcfg).cache_logical(2), name

    m = Model(T.reduced(T.get_arch("mamba2-780m")), device="cpu", seed=4)
    gen = torch.Generator().manual_seed(4)
    for path, spec in leaves(m.specs()):
        t = m.get_parameter(path)
        if spec.init in ("zeros", "ones"):
            continue
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 0.02 if spec.init == "small" else fan_in ** -0.5
        assert torch.equal(t, torch.randn(spec.shape, generator=gen) * scale)
    m = Model(T.reduced(T.get_arch("arctic-480b")), device="cpu", seed=0)
    wi = m.get_parameter("layers.moe.wi")
    assert wi.dtype == torch.bfloat16
    assert abs(float(wi.float().std()) - wi.shape[-2] ** -0.5) < 0.01
    assert abs(float(m.get_parameter("embed.tok").float().std())
               - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def jitted(fn, *static):
    """The reference's `fn`, jitted with every bf16 rounding its code
    writes kept (the subprocess's XLA flag, as a compiler option)."""
    return jax.jit(fn, static_argnums=static, compiler_options=dict(
        xla_allow_excess_precision=False))


def hold_layer(got, want, dtype: str, label: str) -> None:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, label
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=label)
    else:
        assert rel_rms(got, want) <= 1e-2, (label, rel_rms(got, want))


def moe_params(cfg, rng, tie: bool) -> dict:
    """Reduced MoE weights; with `tie` the router's columns give expert 0
    the top logit and experts 1 and 2 equal second ones for every token
    (x[..., 0] = 1 is added 5 times to expert 0's column and subtracted
    from expert 3's), so a top-2 pick must break an exact tie."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = dict(router=rng.normal(0, 0.3, (d, e)),
             wi=rng.normal(0, d ** -0.5, (e, d, 2 * f)),
             wo=rng.normal(0, f ** -0.5, (e, f, d)))
    if tie:
        col = rng.normal(0, 0.3, d)
        p["router"] = np.stack([col, col, col, col], 1)
        p["router"][0, 0] += 5.0
        p["router"][0, 3] -= 5.0
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared_wi"] = rng.normal(0, d ** -0.5, (d, 2 * fs))
        p["shared_wo"] = rng.normal(0, fs ** -0.5, (fs, d))
    if cfg.dense_residual:
        p["dense"] = dict(wi=rng.normal(0, d ** -0.5, (d, 2 * cfg.d_ff)),
                          wo=rng.normal(0, cfg.d_ff ** -0.5, (cfg.d_ff, d)))
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def test_moe_apply_matches_reference():
    """`moe_apply` (y and aux) for deepseek (shared experts) and arctic
    (dense residual) under float32 and bf16, with groups of 40 (B·S) and of
    8, where capacity drops tokens, and with a router that ties experts 1
    and 2 exactly for every token: `top_k` picks what `jax.lax.top_k`
    picks (the lower index), where `torch.topk` need not. A B·S that does
    not split into groups raises, as the reference asserts."""
    rng = np.random.default_rng(7)
    for name in ("deepseek-v2-lite-16b", "arctic-480b"):
        for group, tie in ((64, False), (64, True), (8, True)):
            for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                                    ("bfloat16", jnp.bfloat16,
                                     torch.bfloat16)):
                jcfg, tcfg = cfgs(name, dtype, moe_group=group)
                p = moe_params(tcfg, rng, tie)
                x = rng.normal(0, 1, (2, 20, tcfg.d_model)).astype(np.float32)
                x[..., 0] = 1.0
                want_y, want_aux = jitted(JE.moe_apply, 2)(
                    jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt), jcfg)
                tp = jax.tree.map(torch.from_numpy, p)
                got_y, got_aux = E.moe_apply(tp, torch.from_numpy(x).to(tdt),
                                             tcfg)
                label = f"{name} group {group} tie {tie} {dtype}"
                hold_layer(got_y, want_y, dtype, label)
                np.testing.assert_allclose(
                    float(got_aux), float(want_aux),
                    rtol=1e-5 if dtype == "float32" else 1e-3, err_msg=label)
                if tie:
                    logits = torch.from_numpy(x).to(tdt).reshape(-1, 64) \
                        @ tp["router"].to(tdt)
                    probs = torch.softmax(logits.float(), -1)
                    assert bool((probs[:, 1] == probs[:, 2]).all()), label
                    _, idx = E.top_k(probs, 2)
                    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
                    np.testing.assert_array_equal(idx.numpy(),
                                                  np.asarray(jidx))
                    assert (idx.numpy() == [0, 1]).all(), label
    # Capacity: 40 tokens in one group, cap = int(40 * 2 / 4 * 1.25) = 25,
    # and every token routes to experts 0 and 1, so 15 of each are dropped.
    _, tcfg = cfgs("deepseek-v2-lite-16b", "float32")
    assert max(1, int(40 * 2 / 4 * tcfg.capacity_factor)) == 25
    _, tcfg = cfgs("deepseek-v2-lite-16b", "float32", moe_group=16)
    with pytest.raises(ValueError, match="dispatch groups"):
        E.moe_apply(jax.tree.map(torch.from_numpy, moe_params(tcfg, rng,
                                                              False)),
                    torch.zeros((2, 20, tcfg.d_model)), tcfg)


def test_mla_train_and_decode_match_reference():
    """`mla_train` (with its latent) and three `mla_decode` steps into a
    cache prefilled with the prompt's latent, against the reference under
    float32 and bf16: outputs and the cache (c_kv, k_rope); the decode
    scale is (nd + rd) ** -0.5 and V is padded to K's head dim."""
    rng = np.random.default_rng(8)
    for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        jcfg, tcfg = cfgs("deepseek-v2-lite-16b", dtype)
        specs = M.mla_specs(tcfg)
        p = {k: (rng.normal(0, 0.3, s.shape) if s.init != "ones"
                 else rng.normal(1, 0.1, s.shape)).astype(np.float32)
             for k, s in specs.items()}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        x = rng.normal(0, 1, (2, 10, tcfg.d_model)).astype(np.float32)
        want = jitted(JM.mla_train, 2)(jp, jnp.asarray(x, jdt), jcfg)
        got, (c_kv, k_rope) = M.mla_train(tp, torch.from_numpy(x).to(tdt),
                                          tcfg)
        hold_layer(got, want, dtype, f"mla_train {dtype}")
        pos = jnp.broadcast_to(jnp.arange(10), (2, 10))
        jc, jr = jitted(JM._latent, 2)(jp, jnp.asarray(x, jdt), jcfg, pos)
        hold_layer(c_kv, jc, dtype, "latent")
        hold_layer(k_rope, jr, dtype, "k_rope")

        jcache = JM.init_mla_cache(jcfg, 2, 13)
        jcache = jcache._replace(
            c_kv=jcache.c_kv.at[:, :10].set(jc.astype(jnp.bfloat16)),
            k_rope=jcache.k_rope.at[:, :10].set(jr.astype(jnp.bfloat16)),
            pos=jnp.asarray(10, jnp.int32))
        tcache = M.init_mla_cache(tcfg, 2, 13)
        tcache.c_kv[:, :10] = torch.from_numpy(
            np.asarray(jc.astype(jnp.float32))).bfloat16()
        tcache.k_rope[:, :10] = torch.from_numpy(
            np.asarray(jr.astype(jnp.float32))).bfloat16()
        tcache = tcache._replace(pos=10)
        for step in range(3):
            xd = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
            wy, jcache = jitted(JM.mla_decode, 3)(jp, jnp.asarray(xd, jdt),
                                                 jcache, jcfg)
            gy, tcache = M.mla_decode(tp, torch.from_numpy(xd).to(tdt),
                                      tcache, tcfg)
            hold_layer(gy, wy, dtype, f"mla_decode {dtype} step {step}")
        assert tcache.pos == int(jcache.pos) == 13
        hold_cache(tcache.c_kv, jcache.c_kv, dtype, "c_kv")
        hold_cache(tcache.k_rope, jcache.k_rope, dtype, "k_rope")
        with pytest.raises(ValueError, match="past the end"):
            M.mla_decode(tp, torch.from_numpy(xd).to(tdt), tcache, tcfg)


def test_ssd_and_mamba_decode_match_reference():
    """`softplus` (bf16, both sides of its branches, inf and NaN), the
    causal conv, `ssd_chunked` (a decay strong enough that exp overflows
    above the diagonal: the selected zeros keep NaN out) and three
    `mamba_decode` steps against the reference under float32 and bf16, at
    the reduced widths (P = N, one einsum pairing) and at P < N (the
    other)."""
    rng = np.random.default_rng(9)
    v = np.array([-30, -20.5, -3, -0.5, 0, 0.25, 3, 19.9, 20.1, 30, 100,
                  np.inf, -np.inf, np.nan], np.float32)
    v = np.concatenate([v, rng.normal(0, 8, 500).astype(np.float32)])
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = f32(jitted(jax.nn.softplus)(jnp.asarray(v, jdt)))
        got = f32(S.softplus(torch.from_numpy(v).to(tdt)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=2 ** -7, atol=0)

    for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        for p_dim, n in ((16, 16), (8, 32)):
            b, l, h, chunk = 2, 16, 3, 8
            x = rng.normal(0, 1, (b, l, h, p_dim)).astype(np.float32)
            dt = rng.uniform(0.05, 2.0, (b, l, h)).astype(np.float32)
            dt[0, :, 0] = 60.0                  # exp(+...) overflows
            a_log = rng.normal(0, 1, h).astype(np.float32)
            Bm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
            Cm = rng.normal(0, 1, (b, l, n)).astype(np.float32)
            wy, ws = jitted(JS.ssd_chunked, 5)(
                jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a_log),
                jnp.asarray(Bm), jnp.asarray(Cm), chunk)
            gy, gs = S.ssd_chunked(torch.from_numpy(x).to(tdt),
                                   torch.from_numpy(dt),
                                   torch.from_numpy(a_log),
                                   torch.from_numpy(Bm), torch.from_numpy(Cm),
                                   chunk)
            assert bool(torch.isfinite(gy.float()).all())
            hold_layer(gy, wy, dtype, f"ssd y {dtype} P={p_dim} N={n}")
            hold_layer(gs, ws, dtype, f"ssd state {dtype} P={p_dim} N={n}")
        with pytest.raises(ValueError, match="multiple of the SSD chunk"):
            S.ssd_chunked(torch.from_numpy(x[:, :12]).to(tdt),
                          torch.from_numpy(dt[:, :12]),
                          torch.from_numpy(a_log),
                          torch.from_numpy(Bm[:, :12]),
                          torch.from_numpy(Cm[:, :12]), chunk)

        jcfg, tcfg = cfgs("mamba2-780m", dtype)
        specs = S.mamba_specs(tcfg)
        p = {k: rng.normal(0.5 if s.init == "ones" else 0,
                           0.3 if s.init != "fanin" else s.shape[0] ** -0.5,
                           s.shape).astype(np.float32)
             for k, s in specs.items()}
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        x = rng.normal(0, 1, (2, 16, tcfg.d_model)).astype(np.float32)
        hold_layer(S.mamba_train(tp, torch.from_numpy(x).to(tdt), tcfg),
                   jitted(JS.mamba_train, 2)(jp, jnp.asarray(x, jdt), jcfg),
                   dtype,
                   f"mamba_train {dtype}")
        xc = rng.normal(0, 1, (2, 16, tcfg.d_inner)).astype(np.float32)
        hold_layer(S._conv_causal(torch.from_numpy(xc).to(tdt),
                                  tp["conv_w"].to(tdt), tp["conv_b"].to(tdt)),
                   jitted(JS._conv_causal)(jnp.asarray(xc, jdt),
                                   jp["conv_w"].astype(jdt),
                                   jp["conv_b"].astype(jdt)), dtype, "conv")
        jc = JS.init_mamba_cache(jcfg, 2)
        tc = S.init_mamba_cache(tcfg, 2)
        for step in range(3):
            xd = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
            wy, jc = jitted(JS.mamba_decode, 3)(jp, jnp.asarray(xd, jdt), jc,
                                               jcfg)
            gy, tc = S.mamba_decode(tp, torch.from_numpy(xd).to(tdt), tc,
                                    tcfg)
            hold_layer(gy, wy, dtype, f"mamba_decode {dtype} step {step}")
        hold_cache(tc.conv, jc.conv, dtype, "conv cache")
        hold_cache(tc.state, jc.state, dtype, "state cache")


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_model_matches_reference(refs, name):
    """forward (logits, aux), loss, prefill (last logits and every cache)
    and 8 decode steps from fresh caches (final caches too) against the
    reference under float32 and bf16 compute; the reference's caches carry
    across with `convert.lm_caches_from_numpy` bit for bit."""
    ins = inputs_of(name)
    batch = port_batch(ins)
    for dtype in ("float32", "bfloat16"):
        ref = {k[len(f"{name}/{dtype}/"):]: v for k, v in refs.items()
               if k.startswith(f"{name}/{dtype}/")}
        m = port_model(refs, name, dtype)
        label = f"{name} {dtype}"
        logits, aux = m.forward(batch)
        hold(logits, ref["logits"], dtype, label + " forward")
        np.testing.assert_allclose(float(aux), float(ref["aux"]), rtol=1e-4,
                                   atol=1e-6, err_msg=label)
        loss = m.loss(dict(batch, labels=torch.from_numpy(
            ins["labels"]).long()))
        np.testing.assert_allclose(float(loss), float(ref["loss"]),
                                   rtol=1e-4 if dtype == "float32" else 1e-2)
        p_logits, caches = m.prefill(batch)
        hold(p_logits, ref["prefill_logits"], dtype, label + " prefill")
        got = dict(_leaf_items(caches))
        assert got.keys() == {k[len("prefill/"):] for k in ref
                              if k.startswith("prefill/")}, label
        for k, g in got.items():
            hold_state(g, ref[f"prefill/{k}"], dtype, m.cfg.family,
                       f"{label} prefill {k}")

        c = m.init_caches(2, DECODE)
        if "enc_out" in c:
            c["enc_out"] = caches["enc_out"].to(torch.bfloat16)
        steps = []
        for i in range(DECODE):
            lg, c = m.decode_step(c, torch.from_numpy(
                ins["dec_tokens"][:, i:i + 1]).long())
            steps.append(lg)
        hold_state(torch.stack(steps), ref["steps"], dtype, m.cfg.family,
                   label + " decode", logits=True)
        got = dict(_leaf_items(c))
        assert got.keys() == {k[len("cache/"):] for k in ref
                              if k.startswith("cache/")}, label
        assert got.pop("pos") == int(ref["cache/pos"]) == DECODE
        for k, g in got.items():
            hold_state(g, ref[f"cache/{k}"], dtype, m.cfg.family,
                       f"{label} cache {k}")

        carried = convert.lm_caches_from_numpy(with_dtypes_of(
            {k[len("cache/"):]: v for k, v in ref.items()
             if k.startswith("cache/")}, c, ""))
        assert carried["pos"] == DECODE
        for (k, g), (_, w) in zip(_leaf_items(carried), _leaf_items(c)):
            if k != "pos":
                assert g.dtype == w.dtype, (label, k)
                np.testing.assert_array_equal(f32(g), ref[f"cache/{k}"])


def test_teacher_forced_decode_matches_forward():
    """`test_archs.py`'s decode-against-forward checks on the port, one
    reduced arch of each new family in bf16 (seed-0 port weights, 8
    positions for MoE and enc-dec, 16 for SSM and hybrid at chunk 8):
    deepseek at moe_group 1, the enc-dec with the prompt's encoder output
    in its cache. A decode past a cache's end raises before anything is
    written.

    moe_group 1: the reference's dispatch counts capacity slots per top-k
    rank (a cumsum over the group for each rank), so two tokens routed to
    one expert at different ranks share a slot and the expert runs on
    their sum; a token's output then depends on its group, and a decode
    step (a group of one) equals a forward only when the forward groups
    each token alone. `test_moe_apply_matches_reference` holds the port
    to that dispatch, collisions included."""
    for name, s, tol in (("deepseek-v2-lite-16b", 8, (0.08, 0.05)),
                         ("seamless-m4t-large-v2", 8, (0.08, 0.05)),
                         ("mamba2-780m", 16, (0.15, 0.1)),
                         ("zamba2-1.2b", 16, (0.15, 0.1))):
        _, tcfg = cfgs(name, "bfloat16", moe_group=1)
        m = Model(tcfg, device="cpu", seed=0)
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, tcfg.vocab_size, (1, s)))
        batch = dict(tokens=toks)
        caches = m.init_caches(1, s)
        if tcfg.family == "encdec":
            batch["enc_embeds"] = torch.from_numpy(np.random.default_rng(
                6).normal(0, 1, (1, ENC_FRAMES, tcfg.d_model))).bfloat16()
            caches["enc_out"] = m.prefill(batch)[1]["enc_out"].bfloat16()
        full, _ = m.forward(batch)
        outs = []
        for i in range(s):
            lg, caches = m.decode_step(caches, toks[:, i:i + 1])
            outs.append(lg)
        np.testing.assert_allclose(f32(torch.stack(outs, 1)), f32(full),
                                   atol=tol[0], rtol=tol[1], err_msg=name)
        if tcfg.family != "ssm":
            before = [x.clone() for _, x in _leaf_items(caches)
                      if torch.is_tensor(x)]
            with pytest.raises(ValueError, match="past the end"):
                m.decode_step(caches, toks[:, :1])
            after = [x for _, x in _leaf_items(caches) if torch.is_tensor(x)]
            assert all(torch.equal(a, b) for a, b in zip(after, before))


# ---------------------------------------------------------------------------
# Decode against forward by depth at full width (a script, not a test)
# ---------------------------------------------------------------------------

SWEEP_TOKENS = 64
SWEEP_DEPTHS = {"mamba2-780m": (2, 4, 8, 12, 24),
                "zamba2-1.2b": (2, 6, 8, 12, 18),
                "deepseek-v2-lite-16b": (2, 3)}
ATTN_IN_PROJ = ("wq", "wk", "wv", "w_q", "w_uk", "w_uv")


def sweep_cfg(mod, name: str, depth: int):
    """`name` at full width, `depth` layers, bf16 compute, as
    `chip_smoke.py`'s 11e runs it: the MoE at moe_group 1 with bf16
    parameters, the SSM and hybrid at ssm_chunk 64."""
    cfg = mod.get_arch(name)
    kw = dict(num_layers=depth, dtype="bfloat16")
    if cfg.family == "moe":
        kw.update(moe_group=1, param_dtype="bfloat16")
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_chunk=SWEEP_TOKENS)
    return dataclasses.replace(cfg, **kw)


def fan_in_tree(tree: dict, parent: str = "") -> dict:
    """`chip_smoke.fan_in_attention` on a numpy parameter tree: every
    attention input projection (..., in, heads, hd) times (heads / in) **
    0.5 and every attention output projection wo (..., heads, hd, d) times
    heads ** -0.5, rounded back to the leaf's dtype."""
    out = {}
    for k, v in tree.items():
        scale = None
        if isinstance(v, dict):
            out[k] = fan_in_tree(v, k)
            continue
        if parent in ("attn", "xattn") and k in ATTN_IN_PROJ:
            scale = (v.shape[-2] / v.shape[-3]) ** 0.5
        elif parent in ("attn", "xattn") and k == "wo":
            scale = v.shape[-3] ** -0.5
        out[k] = v if scale is None else \
            (v.astype(np.float32) * np.float32(scale)).astype(v.dtype)
    return out


def logit_gap(dec, full) -> dict:
    dec, full = f32(dec), f32(full)
    return dict(rel_rms=rel_rms(dec, full), agreement=float(
        (dec.argmax(-1) == full.argmax(-1)).mean()))


def depth_sweep(names) -> list:
    """For each arch in `names` and each depth of SWEEP_DEPTHS: 64
    teacher-forced decode steps at batch 1 against `forward`'s logits
    (relative RMS, argmax agreement) in the reference and in the port on
    the CPU, from the reference's `init(PRNGKey(0))` with the attention
    projections at their contraction dimension's fan-in (`fan_in_tree`;
    the SSM has none). Prints one JSON line per (arch, depth)."""
    import gc
    import json
    rows = []
    for name in names:
        for depth in SWEEP_DEPTHS[name]:
            jm = JModel(sweep_cfg(R, name, depth))
            params = jax.tree.map(np.asarray, jax.jit(jm.init)(
                jax.random.PRNGKey(0)))
            if jm.cfg.family != "ssm":
                params = fan_in_tree(params)
            toks = np.random.default_rng(11).integers(
                0, jm.cfg.vocab_size, (1, SWEEP_TOKENS)).astype(np.int32)
            full = jax.jit(jm.forward)(params, dict(tokens=toks))[0]

            def decode(p, c, t, jm=jm):
                return jax.lax.scan(lambda c, x: jm.decode_step(
                    p, c, x[:, None])[::-1], c, t.T)[1]
            dec = jax.jit(decode)(params, jm.init_caches(1, SWEEP_TOKENS),
                                  toks)
            row = dict(arch=name, depth=depth, tokens=SWEEP_TOKENS,
                       reference=logit_gap(np.swapaxes(dec, 0, 1), full))
            del full, dec, jm
            tm = Model(sweep_cfg(T, name, depth), device="cpu")
            tm.load_state_dict(convert.lm_params_from_numpy(params))
            del params
            t_toks = torch.from_numpy(toks).long()
            with torch.no_grad():
                full = tm.forward(dict(tokens=t_toks))[0]
                c, outs = tm.init_caches(1, SWEEP_TOKENS), []
                for i in range(SWEEP_TOKENS):
                    lg, c = tm.decode_step(c, t_toks[:, i:i + 1])
                    outs.append(lg)
            row["port_cpu"] = logit_gap(torch.stack(outs, 1), full)
            del tm, full, outs, c
            gc.collect()
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    # python tests/test_torch_lm_families.py OUT.npz: the reference's
    # outputs for the tests. python tests/test_torch_lm_families.py
    # --depth-sweep [ARCH ...]: `depth_sweep` (run it with XLA_FLAGS=
    # --xla_allow_excess_precision=false, as the tests run the reference).
    if sys.argv[1] == "--depth-sweep":
        depth_sweep(sys.argv[2:] or list(SWEEP_DEPTHS))
    else:
        write_reference(sys.argv[1])
