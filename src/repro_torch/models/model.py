"""The LM API of the reference's `models/model.py`, for the dense family
("dense", "vlm", "audio": qwen1.5-0.5b, yi-34b, nemotron-4-15b,
minitron-8b and llava-next-mistral-7b).

`Model(cfg)` is an `nn.Module` that holds the parameters. Their
`state_dict()` keys are the reference's parameter-tree paths joined by
".", and their shapes are the reference's (stacked over layers), for
example `layers.attn.wq` of shape (L, d, padded_heads, hd), so carrying
weights across packages is a key-for-key copy
(`repro_torch.convert.lm_params_from_numpy`). Where the reference takes
`params` as an argument, the port's methods read the module's own:

    specs()                      — PSpec tree (drives init and the layout)
    forward(batch)               — logits (B, S, padded_vocab), aux
    loss(batch)                  — next-token CE
    prefill(batch)               — last-token logits, per-layer K/V
    init_caches(batch, seq)      — decode caches (bf16, or int8 + scales
                                   under `cfg.kv_quant`)
    cache_logical(batch)         — logical sharding tree of the caches
    decode_step(caches, tokens)  — one-token serve step

`batch` holds "tokens" (B, S) or "embeds" (B, S, d_model) (the vlm/audio
frontend stub), and "labels" for `loss`.

Precision: master weights stay in `cfg.param_dtype` (float32); compute
runs in `cfg.dtype`. The reference casts each weight at its use; the port
casts the whole tree once and reuses it until a parameter changes
(`compute_params`), which gives the same values. KV caches are bf16 even
under `dtype="float32"`, as in the reference.

Decode caches are written in place (`models.attention.attend_decode`) and
carry `pos` as a Python int; a decode past a cache's length raises.

Families the port does not run yet raise NotImplementedError, naming the
slice that brings them. A mesh is accepted only when every axis has size
1; LM sharding comes with its own slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.pspec import init_params, leaves, stack, tree_map

DENSE_FAMILIES = ("dense", "vlm", "audio")
# The port's slice that brings each family not run yet.
LATER_SLICES = {
    "moe": "the MoE / MLA slice (models/moe.py, models/mla.py)",
    "ssm": "the SSM and hybrid slice (models/mamba2.py)",
    "hybrid": "the SSM and hybrid slice (models/mamba2.py)",
    "encdec": "the enc-dec slice (cross-attention)",
}


def _compute_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param_dtype(cfg):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def check_family(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a family the port does not run."""
    if cfg.family in DENSE_FAMILIES:
        return
    if cfg.family in LATER_SLICES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {LATER_SLICES[cfg.family]}. The port runs the "
            f"{'/'.join(DENSE_FAMILIES)} families")
    raise ValueError(f"unknown family {cfg.family!r}")


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


def _module_of(tree: dict) -> nn.Module:
    m = nn.Module()
    _register(m, tree)
    return m


def _register(m: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module_of(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))


class Model(nn.Module):
    """A dense-family LM on one device.

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
        return dict(embed=L.embed_specs(cfg),
                    ln_f=L.rmsnorm_spec(cfg.d_model),
                    layers=stack(B.dense_block_specs(cfg), cfg.num_layers))

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

    # ---- forward ----
    def _embed_in(self, p, batch):
        cfg = self.cfg
        if "embeds" in batch:
            return batch["embeds"].to(_compute_dtype(cfg))
        return L.embed_tokens(p["embed"], batch["tokens"]).to(
            _compute_dtype(cfg))

    @torch.no_grad()
    def forward(self, batch):
        """Full forward -> (logits (B, S, padded_vocab), aux = 0)."""
        cfg = self.cfg
        p = self.compute_params()
        x = self._embed_in(p, batch)
        x, _ = B.scan_stack(B.dense_block, p["layers"], x, cfg)
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        logits = L.unembed(p["embed"], x, cfg)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, batch):
        logits, aux = self.forward(batch)
        ce = L.softmax_xent(logits, batch["labels"], self.cfg.padded_vocab)
        return ce + 0.01 * aux

    # ---- serving ----
    @torch.no_grad()
    def prefill(self, batch):
        """Returns (last-token logits (B, padded_vocab), dict(kv=(k, v)))
        with k, v (L, B, S, Kv, hd) in bf16."""
        cfg = self.cfg
        p = self.compute_params()
        x = self._embed_in(p, batch)
        x, kvs = B.scan_stack(B.dense_block, p["layers"], x, cfg)
        k = torch.stack([k.to(torch.bfloat16) for k, _ in kvs])
        v = torch.stack([v.to(torch.bfloat16) for _, v in kvs])
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        logits = L.unembed(p["embed"], x[:, -1:], cfg)
        return logits[:, 0], dict(kv=(k, v))

    # ---- decode ----
    def init_caches(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)
        dev = self.device

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.kv_quant:
            sshape = shape[:-1]
            return dict(kv=dict(kv=(zeros(shape, torch.int8),
                                    zeros(shape, torch.int8)),
                                scale=(zeros(sshape, torch.float32),
                                       zeros(sshape, torch.float32))),
                        pos=0)
        return dict(kv=self._stacked_kv(batch, seq, cfg.num_layers), pos=0)

    def _stacked_kv(self, batch, seq, n_layers):
        cfg = self.cfg
        shape = (n_layers, batch, seq, cfg.num_kv_heads, cfg.head_dim_)
        return dict(kv=tuple(torch.zeros(shape, dtype=torch.bfloat16,
                                         device=self.device)
                             for _ in range(2)))

    def cache_logical(self, batch: int):
        """Logical-sharding tree with the same structure as init_caches."""
        bl = "dp" if batch > 1 else None
        kv5 = (None, bl, "sp", None, None)       # (L, B, S, Kv, hd)
        if self.cfg.kv_quant:
            sc = (None, bl, "sp", None)
            return dict(kv=dict(kv=(kv5, kv5), scale=(sc, sc)), pos=())
        return dict(kv=dict(kv=(kv5, kv5)), pos=())

    @torch.no_grad()
    def decode_step(self, caches, tokens):
        """tokens: (B, 1) integer -> (logits (B, padded_vocab), caches with
        pos + 1). The cache tensors are updated in place."""
        cfg = self.cfg
        p = self.compute_params()
        x = L.embed_tokens(p["embed"], tokens).to(_compute_dtype(cfg))
        pos = int(caches["pos"])
        kstack, vstack = caches["kv"]["kv"]
        A.check_cache_room(pos, kstack.shape[2])
        quant = cfg.kv_quant
        if quant:
            ks_stack, vs_stack = caches["kv"]["scale"]
        for i in range(cfg.num_layers):
            if quant:
                c = A.Int8KVCache(k=kstack[i], v=vstack[i],
                                  k_scale=ks_stack[i], v_scale=vs_stack[i],
                                  pos=pos)
            else:
                c = A.KVCache(k=kstack[i], v=vstack[i], pos=pos)
            x, _ = B.dense_decode_block(B.layer(p["layers"], i), x, c, cfg)
        x = L.rmsnorm(x, p["ln_f"].to(x.dtype), cfg.norm_eps)
        logits = L.unembed(p["embed"], x, cfg)
        return logits[:, 0], dict(caches, pos=pos + 1)


def _paths(tree, prefix: str = "") -> dict:
    """`tree` with each leaf replaced by its dotted path."""
    return {k: _paths(v, f"{prefix}{k}.") if isinstance(v, dict)
            else f"{prefix}{k}" for k, v in tree.items()}
