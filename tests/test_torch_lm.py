"""The port's LM serving path for the dense family (`repro_torch.configs`,
`repro_torch.models`) against the JAX reference's library path
(`repro.models.model.Model` with mesh=None) on the CPU.

Weights are the reference's `Model.init(PRNGKey(0))` carried across with
`convert.lm_params_from_numpy`, with qwen's q/k/v biases set nonzero
(they init to zero). Inputs come from numpy seeds. Configs are `reduced`
with `attn_chunk = 8`, and prompts of 20 tokens (not a chunk multiple).

The reference runs once, in a subprocess whose XLA keeps every bf16
rounding the reference's code writes (`--xla_allow_excess_precision=
false`). By default XLA on the CPU drops bf16 round trips inside its
fusions (as it does f16 ones, ROADMAP F4): with nonzero qkv biases the
default-jitted reference differs from its own eager run by 2.0% relative
RMS (argmax agreement 0.975) on reduced qwen, while the port equals that
eager run to 6e-10. The port rounds at every step the code writes, as
the eager reference does.

Tolerances, and what an x86 CPU measured (worst over the four archs, the
forward, prefill and 8 decode steps with bf16 and int8 caches):

  float32 compute    logits within rtol 1e-4 and atol 1e-4 x max|logit|,
                     loss rtol 1e-4: measured max |d| 2.6e-6 x max|logit|
  bfloat16 compute   logits: relative RMS <= 1e-2, argmax agreement >=
                     0.95 and `test_archs.py`'s atol 0.08 / rtol 0.05;
                     loss rtol 1e-2: measured relative RMS <= 3.5e-3
                     (nemotron's int8 decode), agreement >= 0.975 (one
                     argmax of 40 in llava's forward), max |d| 9.5e-3 x
                     max|logit|
  caches             prefill K/V and the decode caches after 8 steps,
                     int8 ones dequantized: under float32 compute within
                     one bf16 ulp (rtol 2**-7) or one int8 step; under
                     bf16 relative RMS <= 1e-2 (measured <= 1.4e-3)

The file holds 11 tests, so the tier-1 xdist queue starts it after
`test_stream_properties.py`. Each reduced model's reference functions are
jitted once, as one function per dtype, in the one subprocess of the
module-scope `refs` fixture (`python tests/test_torch_lm.py OUT.npz`
writes them).
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
import repro.configs.base as RB
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.model import Model as JModel

import repro_torch.configs as T
from repro_torch import convert
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.model import Model

DENSE = ["qwen1.5-0.5b", "nemotron-4-15b", "yi-34b", "llava-next-mistral-7b"]
S = 20          # prompt length: not a multiple of the chunk
DECODE = 8
REF_XLA_FLAGS = "--xla_allow_excess_precision=false"
DERIVED = ("head_dim_", "padded_heads", "padded_vocab", "ssm_heads",
           "d_inner")


def cfgs(name: str, dtype: str, kv_quant: bool = False):
    """(reference, port) reduced configs of `name`."""
    kw = dict(attn_chunk=8, dtype=dtype, kv_quant=kv_quant)
    return (dataclasses.replace(R.reduced(R.get_arch(name)), **kw),
            dataclasses.replace(T.reduced(T.get_arch(name)), **kw))


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not torch.is_tensor(x) \
        else x.detach().float().cpu().numpy()


def rel_rms(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.sqrt(((got - want) ** 2).mean())
                 / (np.sqrt((want ** 2).mean()) + 1e-12))


def hold(got, want, dtype: str, label: str) -> None:
    """Logits at the file's tolerance for `dtype`."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, label
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=label)
        return
    assert rel_rms(got, want) <= 1e-2, (label, rel_rms(got, want))
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert agree >= 0.95, (label, agree)
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.08,
                               err_msg=label)


def hold_cache(got, want, dtype: str, label: str, step=None) -> None:
    """Cache values: under float32 compute within one bf16 ulp (rtol
    2**-7), or one int8 step (`step`, the largest scale) for a dequantized
    int8 cache; under bf16 relative RMS <= 1e-2."""
    got, want = f32(got), f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=1e-6 if step is None else step,
                                   err_msg=label)
    else:
        assert rel_rms(got, want) <= 1e-2, (label, rel_rms(got, want))


def dequant(kv) -> tuple:
    """([k, v] of a cache dict as float32 arrays, int8 values dequantized
    by their scales; the largest scale, or None for a bf16 cache)."""
    k, v = (f32(x) for x in kv["kv"])
    if "scale" not in kv:
        return [k, v], None
    ks, vs = (f32(x) for x in kv["scale"])
    return [k * ks[..., None], v * vs[..., None]], float(max(ks.max(),
                                                             vs.max()))


def inputs_of(name: str) -> dict:
    """The seeded inputs of one arch's checks (numpy): the prompt
    ("tokens" or bf16-valued "embeds"), "labels" with three masked, the 8
    teacher-forced decode tokens, and qwen's nonzero biases."""
    cfg = T.reduced(T.get_arch(name))
    rng = np.random.default_rng(DENSE.index(name))
    out = dict(labels=rng.integers(0, cfg.vocab_size, (2, S)))
    out["labels"][0, :3] = -1
    if cfg.embeds_input:
        out["embeds"] = rng.normal(0, 1, (2, S, cfg.d_model)).astype(
            jnp.bfloat16).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (2, S))
    out["dec_tokens"] = rng.integers(0, cfg.vocab_size, (2, DECODE))
    if cfg.qkv_bias:
        for b, shape in (("bq", (cfg.padded_heads, cfg.head_dim_)),
                         ("bk", (cfg.num_kv_heads, cfg.head_dim_)),
                         ("bv", (cfg.num_kv_heads, cfg.head_dim_))):
            out[b] = rng.normal(0, 0.5, (cfg.num_layers,) + shape).astype(
                np.float32)
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in out.items()}


def _leaf_items(tree, prefix=""):
    """(dotted path, leaf) of nested dicts and tuples (a tuple's items are
    keyed by index)."""
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, tuple)):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def write_reference(path: str) -> None:
    """Every reference output the model checks compare with, into one npz:
    per arch the params (`Model.init(PRNGKey(0))`, jitted, with the biases
    of `inputs_of`), and under float32 and bf16, from one jitted function
    each, the forward logits, loss, prefill logits and caches, and 8
    decode steps from fresh caches, bf16 and int8. bf16 values are stored
    as float32 (exactly)."""
    out = {}
    for name in DENSE:
        ins = inputs_of(name)
        jcfg, _ = cfgs(name, "float32")
        params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(
            jax.random.PRNGKey(0)))
        if jcfg.qkv_bias:
            params["layers"]["attn"].update(
                {b: ins[b] for b in ("bq", "bk", "bv")})
        for k, v in _leaf_items(params):
            out[f"{name}/params/{k}"] = v
        batch = {k: jnp.asarray(ins[k], jnp.bfloat16 if k == "embeds"
                                else jnp.int32)
                 for k in ("tokens", "embeds") if k in ins}
        for dtype in ("float32", "bfloat16"):
            models = [JModel(cfgs(name, dtype, q)[0]) for q in (False, True)]

            def run(p, x, labels, dec_tokens):
                m = models[0]
                res = dict(logits=m.forward(p, x)[0],
                           loss=m.loss(p, dict(x, labels=labels)))
                res["prefill_logits"], caches = m.prefill(p, x)
                res["prefill_k"], res["prefill_v"] = caches["kv"]
                for q, mq in enumerate(models):
                    def body(c, t, mq=mq):
                        lg, c = mq.decode_step(p, c, t[:, None])
                        return c, lg
                    c, res[f"kvq{q}/steps"] = jax.lax.scan(
                        body, mq.init_caches(2, DECODE), dec_tokens.T)
                    res[f"kvq{q}/pos"] = c["pos"]
                    res.update({f"kvq{q}/cache/{k}": v
                                for k, v in _leaf_items(c["kv"])})
                return res

            res = jax.jit(run)(params, batch, jnp.asarray(ins["labels"]),
                               jnp.asarray(ins["dec_tokens"]))
            out.update({f"{name}/{dtype}/{k}": v for k, v in res.items()})
    np.savez(path, **{k: np.asarray(v, np.float32)
                      if np.asarray(v).dtype == jnp.bfloat16 else np.asarray(v)
                      for k, v in out.items()})


class Ref:
    """One arch's reference outputs, read from `write_reference`'s file."""

    def __init__(self, name: str, data):
        self.name = name
        self.data = {k[len(name) + 1:]: data[k] for k in data.files
                     if k.startswith(name + "/")}
        self.inputs = inputs_of(name)
        tree: dict = {}
        for k, v in self.data.items():
            if k.startswith("params/"):
                node = tree
                *parents, last = k[len("params/"):].split(".")
                for p in parents:
                    node = node.setdefault(p, {})
                node[last] = v
        self.tree = tree

    def forward(self, dtype: str):
        """(logits, loss, prefill logits, prefill caches (k, v))."""
        d = self.data
        return (d[f"{dtype}/logits"], d[f"{dtype}/loss"],
                d[f"{dtype}/prefill_logits"],
                (d[f"{dtype}/prefill_k"], d[f"{dtype}/prefill_v"]))

    def decode(self, dtype: str, kv_quant: bool):
        """(step logits (8, B, V), final caches as the reference's tree)."""
        dk = f"{dtype}/kvq{int(kv_quant)}"
        kv = dict(kv=(self.data[f"{dk}/cache/kv.0"],
                      self.data[f"{dk}/cache/kv.1"]))
        if kv_quant:
            kv["scale"] = (self.data[f"{dk}/cache/scale.0"],
                           self.data[f"{dk}/cache/scale.1"])
        return self.data[f"{dk}/steps"], dict(kv=kv,
                                              pos=self.data[f"{dk}/pos"])


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's outputs, computed once in a subprocess whose XLA
    keeps every bf16 rounding the reference's code writes
    (`--xla_allow_excess_precision=false`; by default XLA on the CPU
    drops bf16 round trips inside its fusions, see the module
    docstring)."""
    path = tmp_path_factory.mktemp("lm_reference") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        os.environ.get("XLA_FLAGS", "") + " " + REF_XLA_FLAGS).strip())
    res = subprocess.run([sys.executable, __file__, str(path)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    data = np.load(path)
    return {name: Ref(name, data) for name in DENSE}


def port_model(ref: Ref, dtype: str, kv_quant: bool = False) -> Model:
    _, tcfg = cfgs(ref.name, dtype, kv_quant)
    m = Model(tcfg, device="cpu")
    m.load_state_dict(convert.lm_params_from_numpy(ref.tree))
    return m


def port_inputs(ref: Ref) -> dict:
    if "embeds" in ref.inputs:
        return dict(embeds=torch.from_numpy(ref.inputs["embeds"]).bfloat16())
    return dict(tokens=torch.from_numpy(ref.inputs["tokens"]).long())


def port_decode(m: Model, tokens: np.ndarray, caches=None):
    caches = caches if caches is not None else m.init_caches(
        tokens.shape[0], tokens.shape[1])
    outs = []
    for i in range(tokens.shape[1]):
        lg, caches = m.decode_step(
            caches, torch.from_numpy(tokens[:, i:i + 1]).long())
        outs.append(lg)
    return torch.stack(outs), caches


def test_config_registry_matches_reference():
    """Every field and derived property of all ten archs and of their
    `reduced` configs equal the reference's, as do SHAPES and
    shape_applicable."""
    assert sorted(T.ARCHS) == sorted(R.ARCHS)
    for name in R.ARCHS:
        for want, got in ((R.get_arch(name), T.get_arch(name)),
                          (R.reduced(R.get_arch(name)),
                           T.reduced(T.get_arch(name)))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), name
            for prop in DERIVED:
                assert getattr(got, prop) == getattr(want, prop), (name, prop)
            assert got.param_count() == want.param_count(), name
            assert got.active_param_count() == want.active_param_count()
            for shape in RB.SHAPES:
                assert T.shape_applicable(got, T.SHAPES[shape]) \
                    == RB.shape_applicable(want, RB.SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RB.SHAPES.items()}
    with pytest.raises(KeyError):
        T.get_arch("gpt-5")


def test_state_dict_matches_reference_spec_tree():
    """For the five dense/vlm archs at full width, `state_dict` keys and
    shapes equal the reference's abstract parameter tree (laid out on the
    meta device, nothing drawn), and the reduced models' draws follow the
    reference's init rules (ones, zeros, small 0.02, fan-in)."""
    dense = [n for n in R.ARCHS if R.get_arch(n).family in
             ("dense", "vlm", "audio")]
    assert len(dense) == 5
    for name in dense:
        want = {"/".join(str(k.key) for k in path): tuple(x.shape)
                for path, x in jax.tree_util.tree_leaves_with_path(
                    JModel(R.get_arch(name)).abstract())}
        m = Model(T.get_arch(name), device="meta")
        got = {k.replace(".", "/"): tuple(v.shape)
               for k, v in m.state_dict().items()}
        assert got == want, name
    m = Model(T.reduced(T.get_arch("qwen1.5-0.5b")), device="cpu", seed=3)
    sd = m.state_dict()
    assert bool((sd["ln_f"] == 1).all()) and not sd["layers.attn.bq"].any()
    assert abs(float(sd["embed.tok"].std()) - 0.02) < 2e-3
    # fan_in is the second-to-last dimension, as in the reference: for the
    # stacked (L, d, heads, hd) wq that is the 16 padded heads.
    wq = sd["layers.attn.wq"]
    assert abs(float(wq.std()) - 16 ** -0.5) < 0.01
    assert torch.equal(Model(m.cfg, device="cpu", seed=3).state_dict()[
        "layers.attn.wq"], wq)


def test_chunked_attention_matches_reference():
    """`chunked_attention` causal and non-causal with sk = 20 (not a
    multiple of the chunk of 8), and GQA with padded heads (16 query heads
    over 4 KV heads, yi's reduced layout) with a q offset; float32 within
    1e-5 and bf16 within 1 bf16 ulp of the output's scale."""
    rng = np.random.default_rng(0)
    _, tcfg = cfgs("yi-34b", "float32")
    jcfg = dataclasses.replace(R.reduced(R.get_arch("yi-34b")), attn_chunk=8)
    for h, kvh, sq, sk, causal, off in ((4, 4, 20, 20, True, 0),
                                        (4, 4, 12, 20, False, 0),
                                        (16, 4, 5, 20, True, 15)):
        q = rng.normal(0, 1, (2, sq, h, 16)).astype(np.float32)
        k = rng.normal(0, 1, (2, sk, kvh, 16)).astype(np.float32)
        v = rng.normal(0, 1, (2, sk, kvh, 16)).astype(np.float32)
        for dt, jdt, tdt, tol in (("f32", jnp.float32, torch.float32, 1e-5),
                                  ("bf16", jnp.bfloat16, torch.bfloat16,
                                   2 ** -7)):
            want = JA.chunked_attention(
                *(jnp.asarray(x, jdt) for x in (q, k, v)), jcfg,
                causal=causal, q_offset=off)
            got = A.chunked_attention(
                *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), tcfg,
                causal=causal, q_offset=off)
            want = f32(want)
            np.testing.assert_allclose(f32(got), want, rtol=0,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=f"{dt} h={h} causal={causal}")


def test_rmsnorm_rope_quantize_match_reference():
    """`rmsnorm` (float32 and bf16: equal, or within one bf16 ulp),
    `apply_rope` (float32 within 1e-6) and `_quantize_kv`, including
    quotients of exactly k + .5 (half to even: 2.5 -> 2, 3.5 -> 4)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 6, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(
        f32(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        f32(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=0)
    xb = torch.from_numpy(x).bfloat16()
    got = L.rmsnorm(xb, torch.from_numpy(w).bfloat16())
    want = JL.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -7, atol=0)

    xr = rng.normal(0, 1, (2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 6))
    np.testing.assert_allclose(
        f32(L.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e4)),
        f32(JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos, jnp.int32),
                          1e4)), rtol=0, atol=1e-5)

    kv = rng.normal(0, 1, (2, 5, 4, 16)).astype(np.float32)
    # Exact halves: amax 127 gives scale 1.0, so 2.5, -3.5, ... are the
    # quotients themselves.
    kv[0, 0, 0] = 0.0
    kv[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    kv[1, 1, 1] = 0.0                        # scale floor 1e-6 / 127
    for arr in (kv, kv.astype(jnp.bfloat16).astype(np.float32)):
        qj, sj = JA._quantize_kv(jnp.asarray(arr))
        qt, st = A._quantize_kv(torch.from_numpy(arr))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.numpy()[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("name", DENSE)
def test_model_matches_reference(refs, name):
    """forward, loss, prefill (last logits and K/V caches) and 8 decode
    steps from fresh caches (bf16, and int8 under kv_quant) against the
    reference under float32 and bf16 compute: qwen (nonzero qkv biases),
    nemotron (relu2 MLP), yi (56 -> 64 padded heads, GQA 16/4 reduced) and
    llava (embeddings input)."""
    ref = refs[name]
    for dtype in ("float32", "bfloat16"):
        logits, loss, p_logits, p_caches = ref.forward(dtype)
        m = port_model(ref, dtype)
        ins = port_inputs(ref)
        if dtype == "float32":
            back = dict(_leaf_items(convert.lm_params_to_numpy(m)))
            assert back.keys() == dict(_leaf_items(ref.tree)).keys()
            for k, v in _leaf_items(ref.tree):
                np.testing.assert_array_equal(back[k], v, err_msg=k)
        got, _ = m.forward(ins)
        hold(got, logits, dtype, f"{name} {dtype} forward")
        got_loss = m.loss(dict(ins, labels=torch.from_numpy(
            ref.inputs["labels"]).long()))
        np.testing.assert_allclose(float(got_loss), float(loss),
                                   rtol=1e-4 if dtype == "float32" else 1e-2)
        got, caches = m.prefill(ins)
        hold(got, p_logits, dtype, f"{name} {dtype} prefill")
        for g, w, kv in zip(caches["kv"], p_caches, "kv"):
            assert g.dtype == torch.bfloat16
            hold_cache(g, w, dtype, f"{name} {dtype} prefill {kv}")
        for kv_quant in (False, True):
            want, want_c = ref.decode(dtype, kv_quant)
            m = port_model(ref, dtype, kv_quant)
            got, got_c = port_decode(m, ref.inputs["dec_tokens"])
            label = f"{name} {dtype} kv_quant={kv_quant}"
            hold(got, want, dtype, label + " decode")
            assert got_c["pos"] == int(want_c["pos"]) == DECODE
            (gk, gv), _ = dequant(got_c["kv"])
            (wk, wv), step = dequant(want_c["kv"])
            hold_cache(gk, wk, dtype, label + " k cache", step)
            hold_cache(gv, wv, dtype, label + " v cache", step)
            # The reference's caches carried across: bf16 (as ml_dtypes
            # bfloat16 arrays) and int8 values bit for bit, scales float32.
            kv = want_c["kv"]
            ref_c = dict(want_c, kv=dict(kv, kv=tuple(
                x if kv_quant else x.astype(jnp.bfloat16) for x in kv["kv"])))
            port_c = convert.lm_caches_from_numpy(ref_c)
            assert port_c["pos"] == DECODE
            for g, w in zip(port_c["kv"]["kv"] + port_c["kv"].get("scale", ()),
                            kv["kv"] + kv.get("scale", ())):
                assert g.dtype == got_c["kv"]["kv"][0].dtype or g.dtype \
                    == torch.float32
                np.testing.assert_array_equal(f32(g), f32(w))


def test_teacher_forced_decode_matches_forward():
    """`test_archs.py::test_decode_matches_forward_dense` on the port:
    reduced qwen (bf16), chunk 8, 8 teacher-forced decode steps against
    the forward's logits within atol 0.08, rtol 0.05."""
    _, tcfg = cfgs("qwen1.5-0.5b", "bfloat16")
    m = Model(tcfg, device="cpu", seed=0)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (1, 8))
    full, _ = m.forward(dict(tokens=torch.from_numpy(toks)))
    dec, _ = port_decode(m, toks)
    np.testing.assert_allclose(f32(dec.transpose(0, 1)), f32(full),
                               atol=0.08, rtol=0.05)


def test_unported_families_and_cache_overflow_raise():
    """Every family is ported now: what still raises is a family the
    registry does not have (ValueError) and a decode past a cache's
    length, for every cache kind: bf16 KV, int8 KV, the MLA latent
    (deepseek), the hybrid's shared-block KV (zamba2) and the enc-dec
    self-KV (seamless). The reference's clamped write would overwrite the
    last slot; the port raises before writing anything."""
    for name in R.ARCHS:
        Model(T.reduced(T.get_arch(name)), device="meta")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        Model(dataclasses.replace(T.reduced(T.get_arch("qwen1.5-0.5b")),
                                  family="rnn"), device="meta")
    _, tcfg = cfgs("qwen1.5-0.5b", "float32")
    tok = torch.ones((1, 1), dtype=torch.long)
    models = [Model(dataclasses.replace(tcfg, kv_quant=q), device="cpu")
              for q in (False, True)]
    models += [Model(dataclasses.replace(T.reduced(T.get_arch(n)),
                                         dtype="float32"), device="cpu")
               for n in ("deepseek-v2-lite-16b", "zamba2-1.2b",
                         "seamless-m4t-large-v2")]
    for m in models:
        caches = m.init_caches(1, 2)
        for _ in range(2):
            _, caches = m.decode_step(caches, tok)
        before = [x.clone() for _, x in _leaf_items(caches)
                  if torch.is_tensor(x)]
        with pytest.raises(ValueError, match="past the end"):
            m.decode_step(caches, tok)
        after = [x for _, x in _leaf_items(caches) if torch.is_tensor(x)]
        assert all(torch.equal(a, b) for a, b in zip(after, before)), \
            m.cfg.name


def test_lm_modules_import_without_jax():
    """configs/, models/, launch/ and convert import and serve a reduced
    model with `jax` and `repro` unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.convert\n"
        "from repro_torch.launch import serve, mesh\n"
        "rc = serve.main(['--mode', 'lm', '--device', 'cpu', '--reduced', "
        "'--batch', '1', '--prefill', '8', '--decode', '2'])\n"
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


if __name__ == "__main__":
    write_reference(sys.argv[1])
