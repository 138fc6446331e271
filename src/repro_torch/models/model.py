"""The LM API of the reference's `models/model.py`, for every family of
the registry: dense ("dense", "vlm", "audio": qwen1.5-0.5b, yi-34b,
nemotron-4-15b, minitron-8b, llava-next-mistral-7b), MoE (arctic-480b
with GQA and a dense residual, deepseek-v2-lite-16b with MLA and a first
dense layer), SSM (mamba2-780m), hybrid (zamba2-1.2b: Mamba2 groups that
share one attention block) and enc-dec (seamless-m4t-large-v2).

`Model(cfg)` is an `nn.Module` that holds the parameters. Their
`state_dict()` keys are the reference's parameter-tree paths joined by
".", and their shapes are the reference's (stacked over layers), for
example `layers.attn.wq` of shape (L, d, padded_heads, hd), so carrying
weights across packages is a key-for-key copy
(`repro_torch.convert.lm_params_from_numpy`). Where the reference takes
`params` as an argument, the port's methods read the module's own:

    specs()                      — PSpec tree (drives init and the layout)
    forward(batch)               — logits (B, S, padded_vocab), aux
    loss(batch)                  — next-token CE + 0.01 aux
    prefill(batch)               — last-token logits, decode caches
    init_caches(batch, seq)      — empty decode caches (KV, int8 KV under
                                   `cfg.kv_quant`, MLA latent, SSM state)
    cache_logical(batch)         — logical sharding tree of the caches
    decode_step(caches, tokens)  — one-token serve step

`batch` holds "tokens" (B, S) or "embeds" (B, S, d_model) (the vlm/audio
frontend stub); an enc-dec batch holds "enc_embeds" (B, Se, d_model) and
decoder "tokens"; "labels" for `loss`. `aux` is the MoE load-balancing
term (0 for the other families).

Cache trees, as the reference's: dense `kv=dict(kv=(k, v)[, scale=...])`;
MoE `kv=(a, b)` and `first=(a, b)` for a first-k-dense stack, where (a,
b) is (c_kv, k_rope) under MLA and (k, v) otherwise; SSM `ssm=(., .)`;
hybrid `groups=(., .)` (n_groups, attn_every, ...), `attn_kv=(k, v)` (one
KV cache a group for the shared block) and `tail=(., .)`; enc-dec
`self_kv=(k, v)` and `enc_out`. Each holds `pos`. An SSM pair is (conv,
state) in `init_caches` but (state, conv) in `prefill`'s caches: the
reference's order, kept (its decode starts from `init_caches`).

Precision: master weights stay in `cfg.param_dtype`; compute runs in
`cfg.dtype`. The reference casts each weight at its use; the port casts
the whole tree once and reuses it until a parameter changes
(`compute_params`), which gives the same values (no copy when the two
dtypes agree). Attention and latent caches are bf16 even under
`dtype="float32"`, as in the reference; prefill's enc-dec caches keep the
compute dtype, as the reference's do.

Decode caches are written in place and carry `pos` as a Python int; a
decode past an attention cache's length raises before anything is
written. A mesh is accepted only when every axis has size 1; LM sharding
comes with its own slice.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as S
from repro_torch.models import mla as M
from repro_torch.models.pspec import (PSpec, init_params, leaves, stack,
                                      tree_map)

DENSE_FAMILIES = ("dense", "vlm", "audio")
FAMILIES = DENSE_FAMILIES + ("moe", "ssm", "hybrid", "encdec")


def _compute_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param_dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def check_family(cfg: ModelConfig) -> None:
    """Raise ValueError for a family the registry does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"port runs {'/'.join(FAMILIES)}")


def check_mesh(mesh) -> None:
    """Accept None or a mesh whose every axis has size 1."""
    if mesh is not None and any(n != 1 for n in mesh.shape.values()):
        raise NotImplementedError(
            f"the LM runs on one device; a mesh of shape {dict(mesh.shape)} "
            "needs the LM sharding rules (fsdp/sp/model), a later slice")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model was asked for CUDA but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return device


def _register(m: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = nn.Module()
            _register(sub, v)
            m.add_module(k, sub)
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _stack_pairs(pairs, dtype=None) -> tuple:
    """[(a_0, b_0), ...] -> (stack of a, stack of b), cast to `dtype`."""
    return tuple(torch.stack([x if dtype is None else x.to(dtype)
                              for x in xs]) for xs in zip(*pairs))


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_attn_specs(cfg: ModelConfig):
    d, h, hd = cfg.d_model, cfg.padded_heads, cfg.head_dim_
    kv = cfg.num_kv_heads
    kvl = A.kv_logical(cfg)
    return dict(
        wq=PSpec((d, h, hd), ("fsdp", "model", None)),
        wk=PSpec((d, kv, hd), ("fsdp", kvl, None)),
        wv=PSpec((d, kv, hd), ("fsdp", kvl, None)),
        wo=PSpec((h, hd, d), ("model", None, "fsdp")),
    )


def cross_attend(p, x, enc_kv, cfg: ModelConfig):
    """x: (B, Sq, D); enc_kv: (k, v) each (B, Se, Kv, hd). No RoPE."""
    q = A._proj(x, p["wq"])
    k, v = enc_kv
    out = A.chunked_attention(q, k.to(q.dtype), v.to(q.dtype), cfg,
                              causal=False)
    return A._out_proj(out, p["wo"])


def enc_kv_from(p, enc_out, cfg: ModelConfig):
    return A._proj(enc_out, p["wk"]), A._proj(enc_out, p["wv"])


def encoder_block(p, x, cfg: ModelConfig):
    """Bidirectional (non-causal) transformer block."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    b, s, _ = h.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = A._qkv(p["attn"], h, cfg, positions)
    y = A.chunked_attention(q, k, v, cfg, causal=False)
    x = x + A._out_proj(y, p["attn"]["wo"])
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg), None


def decoder_block_specs(cfg: ModelConfig):
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=A.attn_specs(cfg),
        lnx=L.rmsnorm_spec(cfg.d_model),
        xattn=cross_attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        mlp=L.mlp_specs(cfg),
    )


def decoder_block(p, x, enc_kv, cfg: ModelConfig):
    """Causal self-attention, cross-attention to the encoder, MLP;
    returns the output and the layer's self-attention (K, V)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, kv = A.attend_train(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["lnx"].to(x.dtype), cfg.norm_eps)
    x = x + cross_attend(p["xattn"], h, enc_kv, cfg)
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg), kv


def decoder_decode_block(p, x, cache, enc_out, cfg: ModelConfig):
    """One enc-dec decoder layer's decode: self-attention against its KV
    cache, cross-attention to the encoder output (its K/V recomputed at
    every step, as the reference's), MLP."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = A.attend_decode(p["attn"], h, cache, cfg)
    x = x + y
    h = L.rmsnorm(x, p["lnx"].to(x.dtype), cfg.norm_eps)
    x = x + cross_attend(p["xattn"], h, enc_kv_from(p["xattn"], enc_out, cfg),
                         cfg)
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg), cache


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """An LM of any registry family on one device.

    device: where the parameters live (default "cuda", or the mesh's
        device); "meta" lays out shapes without drawing.
    seed: the parameters are drawn from `torch.Generator(device)` seeded
        with it, by the reference's init rules (`models.pspec`), in
        `cfg.param_dtype`.
    mesh: None or a one-device `distributed.sharding.Mesh`.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        check_family(cfg)
        check_mesh(mesh)
        if device is None:
            device = mesh.primary if mesh is not None else "cuda"
        device = _resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
        tree = init_params(self.specs(), gen, _param_dtype(cfg), device)
        _register(self, tree)
        self._cast_key = None
        self._cast = None

    # ---- parameter tree ----
    def specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        out: Dict[str, Any] = dict(embed=L.embed_specs(cfg),
                                   ln_f=L.rmsnorm_spec(cfg.d_model))
        if cfg.family in DENSE_FAMILIES:
            out["layers"] = stack(B.dense_block_specs(cfg), cfg.num_layers)
        elif cfg.family == "moe":
            if cfg.first_k_dense:
                out["first"] = stack(B.dense_ffn_block_specs(cfg),
                                     cfg.first_k_dense)
            out["layers"] = stack(B.moe_block_specs(cfg),
                                  cfg.num_layers - cfg.first_k_dense)
        elif cfg.family == "ssm":
            out["layers"] = stack(B.ssm_block_specs(cfg), cfg.num_layers)
        elif cfg.family == "hybrid":
            n_groups, rem = divmod(cfg.num_layers, cfg.attn_every)
            out["groups"] = stack(stack(B.ssm_block_specs(cfg),
                                        cfg.attn_every), n_groups)
            if rem:
                out["tail"] = stack(B.ssm_block_specs(cfg), rem)
            out["shared_attn"] = B.dense_block_specs(cfg)  # ONE shared block
        else:                                               # encdec
            out["encoder"] = stack(B.dense_block_specs(cfg),
                                   cfg.encoder_layers)
            out["layers"] = stack(decoder_block_specs(cfg), cfg.num_layers)
            out["ln_enc"] = L.rmsnorm_spec(cfg.d_model)
        return out

    def params(self) -> dict:
        """The parameters as the reference's nested tree."""
        return tree_map(self.get_parameter, _paths(self.specs()))

    def compute_params(self) -> dict:
        """The parameter tree cast to the compute dtype, cast once and
        reused while no parameter changes (by storage and version)."""
        tree = self.params()
        dt = _compute_dtype(self.cfg)
        flat = [t for _, t in leaves(tree)]
        if all(t.dtype == dt for t in flat):
            return tree
        key = (dt,) + tuple((t.data_ptr(), t.device, t._version)
                            for t in flat)
        if key != self._cast_key:
            self._cast = tree_map(lambda t: t.to(dt), tree)
            self._cast_key = key
        return self._cast

    @property
    def device(self) -> torch.device:
        return self.ln_f.device

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    # ---- forward ----
    def _embed_in(self, p, batch):
        cfg = self.cfg
        if "embeds" in batch:
            return batch["embeds"].to(_compute_dtype(cfg))
        return L.embed_tokens(p["embed"], batch["tokens"]).to(
            _compute_dtype(cfg))

    def _backbone(self, p, x):
        """The decoder-only stacks: (output, aux)."""
        cfg = self.cfg
        aux = self._zero()
        if cfg.family in DENSE_FAMILIES:
            x, _ = B.scan_stack(B.dense_block, p["layers"], x, cfg)
        elif cfg.family == "moe":
            if cfg.first_k_dense:
                x, _ = B.scan_stack(B.dense_ffn_block, p["first"], x, cfg)
            x, outs = B.scan_stack(B.moe_block, p["layers"], x, cfg)
            aux = torch.sum(torch.stack([a for a, _ in outs]))
        elif cfg.family == "ssm":
            x, _ = B.scan_stack(B.ssm_block, p["layers"], x, cfg)
        else:                                               # hybrid
            for g in range(B.num_layers(p["groups"])):
                x, _ = B.scan_stack(B.ssm_block, B.layer(p["groups"], g), x,
                                    cfg)
                x, _ = B.dense_block(p["shared_attn"], x, cfg)
            if "tail" in p:
                x, _ = B.scan_stack(B.ssm_block, p["tail"], x, cfg)
        return x, aux

    def _encode(self, p, batch):
        cfg = self.cfg
        x = batch["enc_embeds"].to(_compute_dtype(cfg))
        x, _ = B.scan_stack(encoder_block, p["encoder"], x, cfg)
        return L.rmsnorm(x, p["ln_enc"].to(x.dtype), cfg.norm_eps)

    def _decode_stack(self, p, x, enc_out):
        """The enc-dec decoder over its stacked layers: (output, each
        layer's self-attention (K, V))."""
        cfg = self.cfg
        kvs = []
        for i in range(B.num_layers(p["layers"])):
            lp = B.layer(p["layers"], i)
            x, kv = decoder_block(lp, x, enc_kv_from(lp["xattn"], enc_out,
                                                     cfg), cfg)
            kvs.append(kv)
        return x, kvs

    def _decoder_in(self, p, batch):
        x = L.embed_tokens(p["embed"], batch["tokens"])
        return x.to(_compute_dtype(self.cfg))

    @torch.no_grad()
    def forward(self, batch):
        """Full forward -> (logits (B, S, padded_vocab), aux)."""
        cfg = self.cfg
        p = self.compute_params()
        if cfg.family == "encdec":
            enc_out = self._encode(p, batch)
            x, _ = self._decode_stack(p, self._decoder_in(p, batch), enc_out)
            aux = self._zero()
        else:
            x, aux = self._backbone(p, self._embed_in(p, batch))
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        return L.unembed(p["embed"], x, cfg), aux

    def loss(self, batch):
        logits, aux = self.forward(batch)
        ce = L.softmax_xent(logits, batch["labels"], self.cfg.padded_vocab)
        return ce + 0.01 * aux

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, batch):
        """Returns (last-token logits (B, padded_vocab), decode caches of
        the prompt; see the module docstring for each family's tree)."""
        cfg = self.cfg
        p = self.compute_params()
        bf16 = torch.bfloat16
        if cfg.family == "encdec":
            enc_out = self._encode(p, batch)
            x, kvs = self._decode_stack(p, self._decoder_in(p, batch),
                                        enc_out)
            caches = dict(self_kv=_stack_pairs(kvs), enc_out=enc_out)
        elif cfg.family in DENSE_FAMILIES:
            x, kvs = B.scan_stack(B.dense_block, p["layers"],
                                  self._embed_in(p, batch), cfg)
            caches = dict(kv=_stack_pairs(kvs, bf16))
        elif cfg.family == "moe":
            x = self._embed_in(p, batch)
            caches = {}
            if cfg.first_k_dense:
                x, outs = B.scan_stack(B.dense_ffn_block, p["first"], x, cfg)
                caches["first"] = _stack_pairs([c for _, c in outs], bf16)
            x, outs = B.scan_stack(B.moe_block, p["layers"], x, cfg)
            caches["kv"] = _stack_pairs([c for _, c in outs], bf16)
        else:
            # SSM prefill = the train-shape pass capturing final states.
            x, caches = self._ssm_prefill(p, self._embed_in(p, batch))
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        logits = L.unembed(p["embed"], x[:, -1:], cfg)
        return logits[:, 0], caches

    def _ssm_prefill(self, p, x):
        cfg = self.cfg
        block = functools.partial(B.ssm_block, with_state=True)
        caches: Dict[str, Any] = {}
        if cfg.family == "ssm":
            x, states = B.scan_stack(block, p["layers"], x, cfg)
            caches["ssm"] = _stack_pairs(states)
            return x, caches
        groups, kvs = [], []
        for g in range(B.num_layers(p["groups"])):
            x, states = B.scan_stack(block, B.layer(p["groups"], g), x, cfg)
            groups.append(_stack_pairs(states))
            x, kv = B.dense_block(p["shared_attn"], x, cfg)
            kvs.append(kv)
        caches["groups"] = _stack_pairs(groups)
        caches["attn_kv"] = _stack_pairs(kvs, torch.bfloat16)
        if "tail" in p:
            x, states = B.scan_stack(block, p["tail"], x, cfg)
            caches["tail"] = _stack_pairs(states)
        return x, caches

    # ---- decode ----
    def init_caches(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        dev = self.device

        def zeros(shape, dtype=torch.bfloat16):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.family in DENSE_FAMILIES:
            if cfg.kv_quant:
                shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads,
                         cfg.head_dim_)
                sshape = shape[:-1]
                return dict(kv=dict(kv=(zeros(shape, torch.int8),
                                        zeros(shape, torch.int8)),
                                    scale=(zeros(sshape, torch.float32),
                                           zeros(sshape, torch.float32))),
                            pos=0)
            return dict(kv=dict(kv=self._stacked_kv(batch, seq,
                                                    cfg.num_layers)),
                        pos=0)
        if cfg.family == "moe":
            if cfg.use_mla:
                def mk(n):
                    return (zeros((n, batch, seq, cfg.kv_lora_rank)),
                            zeros((n, batch, seq, cfg.qk_rope_head_dim)))
            else:
                def mk(n):
                    return self._stacked_kv(batch, seq, n)
            out = dict(kv=mk(cfg.num_layers - cfg.first_k_dense), pos=0)
            if cfg.first_k_dense:
                out["first"] = mk(cfg.first_k_dense)
            return out
        if cfg.family in ("ssm", "hybrid"):
            c = S.init_mamba_cache(cfg, batch, device=dev)
            if cfg.family == "ssm":
                return dict(ssm=tuple(zeros((cfg.num_layers,) + x.shape)
                                      for x in c), pos=0)
            n_groups, rem = divmod(cfg.num_layers, cfg.attn_every)
            out = dict(groups=tuple(zeros((n_groups, cfg.attn_every)
                                          + x.shape) for x in c),
                       attn_kv=self._stacked_kv(batch, seq, n_groups),
                       pos=0)
            if rem:
                out["tail"] = tuple(zeros((rem,) + x.shape) for x in c)
            return out
        return dict(self_kv=self._stacked_kv(batch, seq, cfg.num_layers),
                    enc_out=zeros((batch, seq, cfg.d_model)), pos=0)

    def _stacked_kv(self, batch, seq, n_layers) -> tuple:
        cfg = self.cfg
        shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)
        return tuple(torch.zeros(shape, dtype=torch.bfloat16,
                                 device=self.device) for _ in range(2))

    def cache_logical(self, batch: int):
        """Logical-sharding tree with the same structure as init_caches."""
        cfg = self.cfg
        bl = "dp" if batch > 1 else None
        kv5 = (None, bl, "sp", None, None)       # (L, B, S, Kv, hd)
        mla4 = (None, bl, "sp", None)            # (L, B, S, r)
        ssm_state = (None, bl, "model", None, None)   # (L, B, H, P, N)
        ssm_conv = (None, bl, None, "model")     # (L, B, 3, d_inner)
        if cfg.family in DENSE_FAMILIES:
            if cfg.kv_quant:
                sc = (None, bl, "sp", None)
                return dict(kv=dict(kv=(kv5, kv5), scale=(sc, sc)), pos=())
            return dict(kv=dict(kv=(kv5, kv5)), pos=())
        if cfg.family == "moe":
            pair = (mla4, mla4) if cfg.use_mla else (kv5, kv5)
            out = dict(kv=pair, pos=())
            if cfg.first_k_dense:
                out["first"] = pair
            return out
        if cfg.family == "ssm":
            return dict(ssm=(ssm_conv, ssm_state), pos=())
        if cfg.family == "hybrid":
            g_conv = (None, None, bl, None, "model")
            g_state = (None, None, bl, "model", None, None)
            out = dict(groups=(g_conv, g_state), attn_kv=(kv5, kv5), pos=())
            if cfg.num_layers % cfg.attn_every:
                out["tail"] = (ssm_conv, ssm_state)
            return out
        return dict(self_kv=(kv5, kv5), enc_out=(bl, "sp", None), pos=())

    def _attention_cache_len(self, caches):
        """The sequence length of the caches' attention (or latent) cache,
        None for an SSM."""
        fam = self.cfg.family
        if fam in DENSE_FAMILIES:
            return caches["kv"]["kv"][0].shape[2]
        key = {"moe": "kv", "hybrid": "attn_kv", "encdec": "self_kv"}.get(fam)
        return None if key is None else caches[key][0].shape[2]

    @torch.no_grad()
    def decode_step(self, caches, tokens):
        """tokens: (B, 1) integer -> (logits (B, padded_vocab), caches with
        pos + 1). The cache tensors are updated in place."""
        cfg = self.cfg
        p = self.compute_params()
        x = L.embed_tokens(p["embed"], tokens).to(_compute_dtype(cfg))
        pos = int(caches["pos"])
        smax = self._attention_cache_len(caches)
        if smax is not None:
            A.check_cache_room(pos, smax)
        fam = cfg.family
        if fam in DENSE_FAMILIES:
            x = self._decode_dense(p, caches, x, pos)
        elif fam == "moe":
            if cfg.first_k_dense:
                x = self._decode_moe(p["first"], caches["first"], x, pos)
            x = self._decode_moe(p["layers"], caches["kv"], x, pos)
        elif fam == "ssm":
            x = self._decode_ssm(p["layers"], caches["ssm"], x)
        elif fam == "hybrid":
            gconv, gstate = caches["groups"]
            ka, va = caches["attn_kv"]
            for g in range(gconv.shape[0]):
                x = self._decode_ssm(B.layer(p["groups"], g),
                                     (gconv[g], gstate[g]), x)
                x, _ = B.dense_decode_block(
                    p["shared_attn"], x, A.KVCache(k=ka[g], v=va[g], pos=pos),
                    cfg)
            if "tail" in caches:
                x = self._decode_ssm(p["tail"], caches["tail"], x)
        else:
            x = self._decode_encdec(p, caches, x, pos)
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        logits = L.unembed(p["embed"], x, cfg)
        return logits[:, 0], dict(caches, pos=pos + 1)

    def _decode_dense(self, p, caches, x, pos):
        cfg = self.cfg
        kstack, vstack = caches["kv"]["kv"]
        if cfg.kv_quant:
            ks_stack, vs_stack = caches["kv"]["scale"]
        for i in range(cfg.num_layers):
            if cfg.kv_quant:
                c = A.Int8KVCache(k=kstack[i], v=vstack[i],
                                  k_scale=ks_stack[i], v_scale=vs_stack[i],
                                  pos=pos)
            else:
                c = A.KVCache(k=kstack[i], v=vstack[i], pos=pos)
            x, _ = B.dense_decode_block(B.layer(p["layers"], i), x, c, cfg)
        return x

    def _decode_moe(self, stacked, pair, x, pos):
        cfg = self.cfg
        c1, c2 = pair
        for i in range(B.num_layers(stacked)):
            if cfg.use_mla:
                c = M.MLACache(c_kv=c1[i], k_rope=c2[i], pos=pos)
            else:
                c = A.KVCache(k=c1[i], v=c2[i], pos=pos)
            x, _ = B.moe_decode_block(B.layer(stacked, i), x, c, cfg)
        return x

    def _decode_ssm(self, stacked, pair, x):
        conv, state = pair
        for i in range(B.num_layers(stacked)):
            x, _ = B.ssm_decode_block(
                B.layer(stacked, i), x,
                S.MambaCache(conv=conv[i], state=state[i]), self.cfg)
        return x

    def _decode_encdec(self, p, caches, x, pos):
        cfg = self.cfg
        enc_out = caches["enc_out"].to(x.dtype)
        kstack, vstack = caches["self_kv"]
        for i in range(cfg.num_layers):
            x, _ = decoder_decode_block(
                B.layer(p["layers"], i), x,
                A.KVCache(k=kstack[i], v=vstack[i], pos=pos), enc_out, cfg)
        return x


def _paths(tree, prefix: str = "") -> dict:
    """`tree` with each leaf replaced by its dotted path."""
    return {k: _paths(v, f"{prefix}{k}.") if isinstance(v, dict)
            else f"{prefix}{k}" for k, v in tree.items()}
