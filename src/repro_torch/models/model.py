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
    loss(batch)                  — next-token CE + 0.01 aux, differentiable
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

Training: `loss` carries gradients to the parameters once they are
trainable (`model.requires_grad_(True)`, as `launch.steps`' train step
does; serving leaves them frozen). `forward`, `prefill` and
`decode_step` run without autograd. Under autograd each stacked block is
checkpointed, as by the reference's `scan_stack` (its `remat=True`); the
hybrid's group of Mamba2 blocks and its shared attention block are
checkpointed as one, as the reference's `jax.checkpoint(group_fn)`.

Precision: master weights stay in `cfg.param_dtype`; compute runs in
`cfg.dtype`. The reference casts each weight at its use; the port casts
the whole tree once (`compute_params`), which gives the same values (no
copy when the two dtypes agree). Without autograd the cast is reused
until a parameter changes; under autograd it is cast afresh for each
forward, so each backward runs through its own cast. Attention and
latent caches are bf16 even under `dtype="float32"`, as in the
reference; prefill's enc-dec caches keep the compute dtype, as the
reference's do.

Decode caches are written in place and carry `pos` as a Python int; a
decode past an attention cache's length raises before anything is
written.

Over a mesh (the dense family; `check_mesh`): the parameters are held as
`distributed.sharding.Sharded` pieces, placed by `shardings()` (the
reference's rules, `models.pspec.shardings`), and drawn as on one device
then placed, so a sharded model has an unsharded one's weights.
`params()` is then a tree of `Sharded`; `state_dict()` gives the gathered
tensors and `load_state_dict` places them. The batch goes over the data
rows of the mesh when they divide it and it holds more than one
sequence, else every row holds all of it (`loss` and `forward` then run
row 0 only, the others would repeat it); each row runs the layers
tensor-parallel over its "model" positions, the weights gathered over
the FSDP axes at use, inside each layer's checkpoint. Decode caches are
`Sharded` by `cache_logical` (sequence over "model"). `forward`,
`prefill` and `decode_step` return whole logits on the primary device.
A mesh with one device runs the one-device code.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as S
from repro_torch.models import mla as M
from repro_torch.models import pspec
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


def is_sharded(mesh) -> bool:
    """True for a mesh of more than one position."""
    return mesh is not None and mesh.size > 1


def check_mesh(mesh, cfg: ModelConfig) -> None:
    """Accept None, a one-device mesh, or any mesh for the dense family;
    raise NotImplementedError for another family over a larger mesh."""
    if is_sharded(mesh) and cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family runs on one device; a "
            f"mesh of shape {dict(mesh.shape)} needs its sharding (MoE "
            "experts over model, MLA, the SSM's d_inner, the hybrid's "
            "shared block, cross-attention), the next LM mesh slice. The "
            "dense family runs over any mesh")


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
    """An LM of any registry family on one device, or of the dense family
    over a mesh.

    device: where the parameters are drawn (default "cuda", or the
        mesh's primary device); "meta" lays out shapes without drawing.
    seed: the parameters are drawn from `torch.Generator(device)` seeded
        with it, by the reference's init rules (`models.pspec`), in
        `cfg.param_dtype`.
    mesh: None or a `distributed.sharding.Mesh`; over more than one
        position the drawn parameters are placed on it (`shardings()`).
    """

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 mesh=None):
        super().__init__()
        check_family(cfg)
        check_mesh(mesh, cfg)
        if device is None:
            device = mesh.primary if mesh is not None else "cuda"
        device = _resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device).manual_seed(seed)
        tree = init_params(self.specs(), gen, _param_dtype(cfg), device)
        self._sharded = None
        if is_sharded(mesh):
            self._sharded = D.shard_tree(tree, self.shardings())
        else:
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

    def shardings(self) -> dict:
        """The parameters' placements on the model's mesh."""
        return pspec.shardings(self.specs(), self.mesh,
                               self.cfg.fsdp_over_pod)

    def params(self) -> dict:
        """The parameters as the reference's nested tree (of `Sharded`
        over a mesh)."""
        if self._sharded is not None:
            return self._sharded
        return tree_map(self.get_parameter, _paths(self.specs()))

    def requires_grad_(self, requires_grad: bool = True):
        if self._sharded is not None:
            for _, t in leaves(self._sharded):
                for p in t.pieces:
                    p.requires_grad_(requires_grad)
        return super().requires_grad_(requires_grad)

    def state_dict(self, *args, **kwargs):
        """Over a mesh: the gathered parameters by dotted path."""
        if self._sharded is None:
            return super().state_dict(*args, **kwargs)
        return {path: t.gather().detach()
                for path, t in leaves(self._sharded)}

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """Over a mesh: each whole tensor placed into the pieces."""
        if self._sharded is None:
            return super().load_state_dict(state_dict, strict=strict,
                                           assign=assign)
        with torch.no_grad():
            for path, t in leaves(self._sharded):
                new = D.shard(state_dict[path].to(t.dtype), t.sharding)
                for p, q in zip(t.pieces, new):
                    p.copy_(q)

    def compute_params(self) -> dict:
        """The parameter tree cast to the compute dtype. Without autograd
        the cast is reused while no parameter changes (by storage and
        version); under autograd it is made afresh, on the tape."""
        tree = self.params()
        dt = _compute_dtype(self.cfg)
        cast = (lambda t: t.map(lambda p: p.to(dt))) \
            if self._sharded is not None else (lambda t: t.to(dt))
        flat = [p for _, t in leaves(tree)
                for p in (t.pieces if self._sharded is not None else [t])]
        if all(t.dtype == dt for t in flat):
            return tree
        if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
            return tree_map(cast, tree)
        key = (dt,) + tuple((t.data_ptr(), t.device, t._version)
                            for t in flat)
        if key != self._cast_key:
            self._cast = tree_map(cast, tree)
            self._cast_key = key
        return self._cast

    @property
    def device(self) -> torch.device:
        if self._sharded is not None:
            return self.mesh.primary
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
        """The decoder-only stacks: (output, aux). Only the MoE's aux is
        kept of the blocks' second results."""
        cfg = self.cfg
        aux = self._zero()
        stack = functools.partial(B.scan_stack, cfg=cfg, keep=_drop)
        if cfg.family in DENSE_FAMILIES:
            x, _ = stack(B.dense_block, p["layers"], x)
        elif cfg.family == "moe":
            if cfg.first_k_dense:
                x, _ = stack(B.dense_ffn_block, p["first"], x)
            x, auxs = stack(B.moe_block, p["layers"], x,
                            keep=lambda out: out[0])
            aux = torch.sum(torch.stack(auxs))
        elif cfg.family == "ssm":
            x, _ = stack(B.ssm_block, p["layers"], x)
        else:                                               # hybrid
            def group(gp, shared, x):
                x, _ = B.scan_stack(B.ssm_block, gp, x, cfg, remat=False)
                return B.dense_block(shared, x, cfg)[0]

            for gp in B.unstack(p["groups"]):
                x = B.remat_call(group, gp, p["shared_attn"], x)
            if "tail" in p:
                x, _ = stack(B.ssm_block, p["tail"], x)
        return x, aux

    def _encode(self, p, batch):
        cfg = self.cfg
        x = batch["enc_embeds"].to(_compute_dtype(cfg))
        x, _ = B.scan_stack(encoder_block, p["encoder"], x, cfg, keep=_drop)
        return L.rmsnorm(x, p["ln_enc"].to(x.dtype), cfg.norm_eps)

    def _decode_stack(self, p, x, enc_out, keep=B.keep_all):
        """The enc-dec decoder over its stacked layers: (output, `keep` of
        each layer's self-attention (K, V)); each layer's cross-attention
        K/V are computed inside its (checkpointed) block."""
        cfg = self.cfg

        def block(lp, x, cfg):
            return decoder_block(lp, x, enc_kv_from(lp["xattn"], enc_out,
                                                    cfg), cfg)
        return B.scan_stack(block, p["layers"], x, cfg, keep=keep)

    def _decoder_in(self, p, batch):
        x = L.embed_tokens(p["embed"], batch["tokens"])
        return x.to(_compute_dtype(self.cfg))

    def _forward(self, batch):
        cfg = self.cfg
        p = self.compute_params()
        if cfg.family == "encdec":
            enc_out = self._encode(p, batch)
            x, _ = self._decode_stack(p, self._decoder_in(p, batch), enc_out,
                                      keep=_drop)
            aux = self._zero()
        else:
            x, aux = self._backbone(p, self._embed_in(p, batch))
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        return L.unembed(p["embed"], x, cfg), aux

    @torch.no_grad()
    def forward(self, batch):
        """Full forward -> (logits (B, S, padded_vocab), aux)."""
        if self._sharded is not None:
            return self._tp_forward(batch)
        return self._forward(batch)

    def loss(self, batch):
        """Next-token cross entropy + 0.01 aux: a 0-d float32 tensor, on
        the autograd tape when the parameters are trainable."""
        if self._sharded is not None:
            return self._tp_loss(batch)
        logits, aux = self._forward(batch)
        ce = L.softmax_xent(logits, batch["labels"], self.cfg.padded_vocab)
        return ce + 0.01 * aux

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, batch):
        """Returns (last-token logits (B, padded_vocab), decode caches of
        the prompt; see the module docstring for each family's tree)."""
        if self._sharded is not None:
            return self._tp_prefill(batch)
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
    def init_caches(self, batch: int, seq: int, device=None) -> dict:
        """Empty decode caches; over a mesh `Sharded` by `cache_logical`.
        `device` makes them whole on that device instead ("meta" for
        shapes only)."""
        if self._sharded is not None and device is None:
            return self._tp_init_caches(batch, seq)
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)

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
                                                    cfg.num_layers, dev)),
                        pos=0)
        if cfg.family == "moe":
            if cfg.use_mla:
                def mk(n):
                    return (zeros((n, batch, seq, cfg.kv_lora_rank)),
                            zeros((n, batch, seq, cfg.qk_rope_head_dim)))
            else:
                def mk(n):
                    return self._stacked_kv(batch, seq, n, dev)
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
                       attn_kv=self._stacked_kv(batch, seq, n_groups, dev),
                       pos=0)
            if rem:
                out["tail"] = tuple(zeros((rem,) + x.shape) for x in c)
            return out
        return dict(self_kv=self._stacked_kv(batch, seq, cfg.num_layers, dev),
                    enc_out=zeros((batch, seq, cfg.d_model)), pos=0)

    def _stacked_kv(self, batch, seq, n_layers, device) -> tuple:
        cfg = self.cfg
        shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)
        return tuple(torch.zeros(shape, dtype=torch.bfloat16,
                                 device=device) for _ in range(2))

    def input_specs(self, shape) -> dict:
        """The batch of a `configs.ShapeConfig` as tensors on the meta
        device (the reference's `input_specs`): train batches with
        "labels", prefill without, decode (B, 1) tokens."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def meta(shape_, dtype=torch.int64):
            return torch.empty(shape_, dtype=dtype, device="meta")
        if shape.kind == "decode":
            return dict(tokens=meta((b, 1)))
        if cfg.family == "encdec":
            out = dict(enc_embeds=meta((b, s // 2, cfg.d_model),
                                       torch.bfloat16),
                       tokens=meta((b, s // 2)), labels=meta((b, s // 2)))
        elif cfg.embeds_input:
            out = dict(embeds=meta((b, s, cfg.d_model), torch.bfloat16),
                       labels=meta((b, s)))
        else:
            out = dict(tokens=meta((b, s)), labels=meta((b, s)))
        if shape.kind == "prefill":
            out.pop("labels")
        return out

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
        if self._sharded is not None:
            return self._tp_decode_step(caches, tokens)
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


    # ---- over a mesh (dense family) ----
    def _tp_rows(self, batch) -> tuple:
        """(each data row's batch, whether the batch was split): split
        over the rows when they divide it and B > 1, else whole at each."""
        b = next(iter(batch.values())).shape[0]
        n = len(self.mesh.rows())
        split = b % n == 0 and b > 1
        if not split:
            return [batch] * n, False
        return [{k: v.chunk(n)[r] for k, v in batch.items()}
                for r in range(n)], True

    def _tp_devices(self, r: int) -> list:
        fd = self.mesh.flat_devices()
        return [fd[i] for i in self.mesh.rows()[r]]

    def _tp_hidden(self, p, rows, with_kv: bool = False):
        """The layers over `rows` (row batches, from row 0): (each row's
        boundary-layout output, each row's (B_r, S, D) shape, per layer
        each row's per-position (k, v) with `with_kv`)."""
        cfg, mesh = self.cfg, self.mesh
        dt = _compute_dtype(cfg)
        g = B.fsdp_gather(p["embed"], mesh)
        xs_rows, shapes = [], []
        for r, rb in enumerate(rows):
            devs = self._tp_devices(r)
            if "embeds" in rb:
                xs = [rb["embeds"].to(dev) for dev in devs]
            else:
                xs = L.embed_tokens_tp(B.row_params(g, mesh.rows()[r]),
                                       rb["tokens"], cfg, devs)
            xs = [x.to(dt) for x in xs]
            shapes.append(xs[0].shape)
            xs_rows.append(B.boundary(xs, devs))

        def layer(lp, xs_rows):
            return B.dense_block_tp(lp, xs_rows, shapes, cfg, mesh)[0]
        kvs = []
        for lp in B.unstack_sharded(p["layers"]):
            if with_kv:
                xs_rows, kv = B.dense_block_tp(lp, xs_rows, shapes, cfg,
                                               mesh, with_kv=True)
                kvs.append(kv)
            else:
                xs_rows = B.remat_call(layer, lp, xs_rows)
        return xs_rows, shapes, kvs

    def _tp_logits(self, p, xs_rows, shapes, last: bool = False) -> list:
        """Each row's vocab-sharded logits (a list over its positions), of
        the last token only with `last`."""
        mesh = self.mesh
        g = B.fsdp_gather(dict(embed=p["embed"], ln_f=p["ln_f"]), mesh)
        out = []
        for r, (xs, shape) in enumerate(zip(xs_rows, shapes)):
            devs = self._tp_devices(r)
            pr = B.row_params(g, mesh.rows()[r])
            h = B.normed(xs, pr["ln_f"], shape, self.cfg, devs)
            if last:
                h = [x[:, -1:] for x in h]
            out.append(L.unembed_tp(pr["embed"], h, self.cfg))
        return out

    def _tp_whole(self, logits_rows, split: bool) -> torch.Tensor:
        """Whole logits on the primary device from the rows' vocab
        shards (row 0's when the batch was not split)."""
        dev = self.mesh.primary
        rows = [torch.cat([x.to(dev) for x in ls], -1)
                for ls in (logits_rows if split else logits_rows[:1])]
        return torch.cat(rows, 0)

    def _tp_forward(self, batch):
        rows, split = self._tp_rows(batch)
        rows = rows if split else rows[:1]
        p = self.compute_params()
        xs_rows, shapes, _ = self._tp_hidden(p, rows)
        logits = self._tp_whole(self._tp_logits(p, xs_rows, shapes), split)
        return logits, self._zero()

    def _tp_loss(self, batch):
        """The masked NLL summed over the rows' vocab shards, over the
        batch's global count of unmasked labels."""
        rows, split = self._tp_rows(batch)
        rows = rows if split else rows[:1]
        p = self.compute_params()
        xs_rows, shapes, _ = self._tp_hidden(p, rows)
        dev = self.mesh.primary
        total = None
        for rb, ls in zip(rows, self._tp_logits(p, xs_rows, shapes)):
            nll = L.softmax_xent_tp(ls, rb["labels"]).to(dev)
            total = nll if total is None else total + nll
        count = torch.clamp(torch.sum(batch["labels"].to(dev) >= 0), min=1)
        return total / count + 0.01 * self._zero()

    def _tp_prefill(self, batch):
        """Every row runs (a batch it does not split is repeated at each
        row, as its caches are); the caches are `Sharded`, their
        sequence over "model"."""
        cfg, mesh = self.cfg, self.mesh
        rows, split = self._tp_rows(batch)
        p = self.compute_params()
        xs_rows, shapes, kvs = self._tp_hidden(p, rows, with_kv=True)
        b, s = next(iter(batch.values())).shape[:2]
        kv5 = (None, "dp" if split else None, "sp", None, None)
        sh = D.named(self.mesh, kv5)
        sh.check((cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim_))
        blocks = [[] for _ in range(mesh.size)]    # per position, per layer
        for layer_kvs in kvs:
            for r, row_kv in enumerate(layer_kvs):
                devs = self._tp_devices(r)
                for i, kv in zip(mesh.rows()[r],
                                 A.cache_blocks(row_kv, cfg, devs)):
                    blocks[i].append(kv)
        k = D.Sharded([torch.stack([kv[0] for kv in bl]).to(torch.bfloat16)
                       for bl in blocks], sh)
        v = D.Sharded([torch.stack([kv[1] for kv in bl]).to(torch.bfloat16)
                       for bl in blocks], sh)
        logits = self._tp_whole(self._tp_logits(p, xs_rows, shapes,
                                                last=True), split)
        return logits[:, 0], dict(kv=(k, v))

    def _tp_init_caches(self, batch: int, seq: int) -> dict:
        cfg, mesh = self.cfg, self.mesh
        shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)

        def zeros(shape, logical, dtype):
            sh = D.named(self.mesh, logical)
            local = sh.local_shape(shape)
            return D.Sharded([torch.zeros(local, dtype=dtype, device=d)
                              for d in mesh.flat_devices()], sh)
        logical = self.cache_logical(batch)["kv"]
        kv = tuple(zeros(shape, lg, torch.int8 if cfg.kv_quant
                         else torch.bfloat16) for lg in logical["kv"])
        if not cfg.kv_quant:
            return dict(kv=dict(kv=kv), pos=0)
        sc = tuple(zeros(shape[:-1], lg, torch.float32)
                   for lg in logical["scale"])
        return dict(kv=dict(kv=kv, scale=sc), pos=0)

    def _tp_decode_step(self, caches, tokens):
        cfg, mesh = self.cfg, self.mesh
        pos = int(caches["pos"])
        kst, vst = caches["kv"]["kv"]
        A.check_cache_room(pos, kst.shape[2])
        rows, split = self._tp_rows(dict(tokens=tokens))
        if (kst.sharding.spec[1] is not None) != split:
            raise ValueError(f"a batch of {tokens.shape[0]} against caches "
                             f"placed {kst.sharding.spec}")
        p = self.compute_params()
        g = B.fsdp_gather(p["embed"], mesh)
        dt = _compute_dtype(cfg)
        xs_rows = [[x.to(dt) for x in L.embed_tokens_tp(
            B.row_params(g, mesh.rows()[r]), rb["tokens"], cfg,
            self._tp_devices(r))] for r, rb in enumerate(rows)]
        scales = caches["kv"].get("scale")
        for i, lp in enumerate(B.unstack_sharded(p["layers"])):
            def cache(j):
                if cfg.kv_quant:
                    return A.Int8KVCache(
                        k=kst.pieces[j][i], v=vst.pieces[j][i],
                        k_scale=scales[0].pieces[j][i],
                        v_scale=scales[1].pieces[j][i], pos=pos)
                return A.KVCache(k=kst.pieces[j][i], v=vst.pieces[j][i],
                                 pos=pos)
            cs = [[cache(j) for j in row] for row in mesh.rows()]
            xs_rows = B.dense_decode_block_tp(lp, xs_rows, cs, pos, cfg,
                                              mesh)
        shapes = [xs[0].shape for xs in xs_rows]
        xs_rows = [B.boundary(xs, self._tp_devices(r))
                   for r, xs in enumerate(xs_rows)]
        logits = self._tp_whole(self._tp_logits(p, xs_rows, shapes), split)
        return logits[:, 0], dict(caches, pos=pos + 1)


def _drop(out) -> None:
    return None


def _paths(tree, prefix: str = "") -> dict:
    """`tree` with each leaf replaced by its dotted path."""
    return {k: _paths(v, f"{prefix}{k}.") if isinstance(v, dict)
            else f"{prefix}{k}" for k, v in tree.items()}
