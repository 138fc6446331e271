"""Block assembly for every family (dense, MoE with MLA or GQA, SSM), and
the loop over the stacked layer axis.

The reference runs its stacked layers with `lax.scan` under
`jax.checkpoint` (remat) and pins activation shardings at block
boundaries (`boundary`, `gathered`). On one device those constraints are
the identity, so here a block is plain code and `scan_stack` is a Python
loop over the leading axis of each stacked tensor (views, no per-layer
copies). With gradients enabled, each block runs under
`torch.utils.checkpoint` (`remat`, on by default as in the reference):
the backward recomputes the block's activations from its input instead
of keeping them.

Over a mesh the constraints are the collectives they imply, on the
residual stream of one data row (a list over the "model" positions):
`boundary` leaves it sequence-sharded ("sp") when the model axis divides
S, else sharded over d_model when it divides that, else replicated;
`gathered` makes it replicated. A row-parallel output (a partial sum at
each position) reaches the boundary by a reduce-scatter (`add_partial`).
`dense_block_tp` runs one dense layer over every data row of the mesh,
its weights gathered over the FSDP axes at use.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as D
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as S
from repro_torch.models import mla as M
from repro_torch.models import moe as E
from repro_torch.models.pspec import tree_map


def layer(params_stacked, i: int):
    """Layer i's parameters: a view of each stacked tensor."""
    return tree_map(lambda t: t[i], params_stacked)


def unstack(params_stacked) -> list:
    """Every layer's parameters: views from one `unbind` of each stacked
    tensor, whose backward stacks the layers' gradients once (indexing
    layer by layer would write a full-size gradient for every layer)."""
    n = num_layers(params_stacked)
    parts = tree_map(lambda t: t.unbind(0), params_stacked)
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


def remat_call(fn, *args):
    """`fn(*args)`, under `torch.utils.checkpoint` when gradients are
    enabled."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def num_layers(params_stacked) -> int:
    t = params_stacked
    while isinstance(t, dict):
        t = next(iter(t.values()))
    return t.shape[0]


def dense_block_specs(cfg: ModelConfig):
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=A.attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        mlp=L.mlp_specs(cfg),
    )


def dense_block(p, x, cfg: ModelConfig):
    """One pre-norm block; returns the output and the layer's (K, V)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, kv = A.attend_train(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg)
    return x, kv


def _attn_specs(cfg: ModelConfig):
    return M.mla_specs(cfg) if cfg.use_mla else A.attn_specs(cfg)


def _attend(p, h, cfg: ModelConfig):
    """MLA or GQA self-attention of an MoE-family layer: its output and
    its decode cache (the MLA latent (c_kv, k_rope), or (K, V))."""
    fn = M.mla_train if cfg.use_mla else A.attend_train
    return fn(p, h, cfg)


def moe_block_specs(cfg: ModelConfig):
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=_attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        moe=E.moe_specs(cfg),
    )


def moe_block(p, x, cfg: ModelConfig):
    """Returns the output and (the layer's MoE `aux`, its decode cache)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = _attend(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    y, aux = E.moe_apply(p["moe"], h, cfg)
    return x + y, (aux, cache)


def dense_ffn_block_specs(cfg: ModelConfig):
    """DeepSeek's first-k-dense layer: MLA (or GQA) attention + SwiGLU."""
    return dict(
        ln1=L.rmsnorm_spec(cfg.d_model),
        attn=_attn_specs(cfg),
        ln2=L.rmsnorm_spec(cfg.d_model),
        mlp=L.mlp_specs(cfg),
    )


def dense_ffn_block(p, x, cfg: ModelConfig):
    """Returns the output and (None, the layer's decode cache)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = _attend(p["attn"], h, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg), (None, cache)


def ssm_block_specs(cfg: ModelConfig):
    return dict(
        ln=L.rmsnorm_spec(cfg.d_model),
        mixer=S.mamba_specs(cfg),
    )


def ssm_block(p, x, cfg: ModelConfig, with_state: bool = False):
    """One pre-norm Mamba2 block; with `with_state`, its second result is
    the layer's (final SSD state, conv tail) for a decode cache."""
    h = L.rmsnorm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    if with_state:
        y, st, conv_tail = S.mamba_train(p["mixer"], h, cfg, with_state=True)
        return x + y, (st, conv_tail)
    return x + S.mamba_train(p["mixer"], h, cfg), None


def keep_all(out):
    return out


def scan_stack(block_fn, params_stacked, x, cfg: ModelConfig,
               remat: bool = True, keep=keep_all):
    """Run `block_fn` over the stacked layers in order; returns the output
    and the list of `keep` of each layer's second result. With `remat`
    (and gradients enabled) each block is checkpointed; `keep` runs
    inside it, so a result the caller drops is not kept either."""
    def run(lp, x):
        x, out = block_fn(lp, x, cfg)
        return x, keep(out)

    outs = []
    for lp in unstack(params_stacked):
        x, out = remat_call(run, lp, x) if remat else run(lp, x)
        outs.append(out)
    return x, outs


def dense_decode_block(p, x, cache, cfg: ModelConfig):
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    y, cache = A.attend_decode(p["attn"], h, cache, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg)
    return x, cache


def moe_decode_block(p, x, cache, cfg: ModelConfig):
    """An MoE-family layer's decode: MLA or GQA attention against its
    cache, then the experts (or the dense MLP of a first-k-dense layer)."""
    h = L.rmsnorm(x, p["ln1"].to(x.dtype), cfg.norm_eps)
    if cfg.use_mla:
        y, cache = M.mla_decode(p["attn"], h, cache, cfg)
    else:
        y, cache = A.attend_decode(p["attn"], h, cache, cfg)
    x = x + y
    h = L.rmsnorm(x, p["ln2"].to(x.dtype), cfg.norm_eps)
    if "moe" in p:
        y, _ = E.moe_apply(p["moe"], h, cfg)
    else:
        y = L.mlp_apply(p["mlp"], h, cfg)
    return x + y, cache


def ssm_decode_block(p, x, cache, cfg: ModelConfig):
    h = L.rmsnorm(x, p["ln"].to(x.dtype), cfg.norm_eps)
    y, cache = S.mamba_decode(p["mixer"], h, cache, cfg)
    return x + y, cache


# --- over a mesh ------------------------------------------------------------

def layout(shape, nm: int):
    """Where `boundary` puts a (B, S, D) residual over `nm` model shards:
    the dimension it splits (1 or 2), or None (replicated)."""
    if shape[1] % nm == 0 and shape[1] >= nm:
        return 1
    return 2 if shape[-1] % nm == 0 else None


def boundary(xs, devices) -> list:
    """A replicated row tensor (a list over the model positions) in the
    boundary layout: each position keeps its block."""
    dim = layout(xs[0].shape, len(devices))
    if dim is None:
        return list(xs)
    return [x.chunk(len(devices), dim)[m] for m, x in enumerate(xs)]


def gathered(xs, shape, devices) -> list:
    """The boundary-layout row tensor of full `shape`, replicated at every
    position (an all-gather, or nothing when it was replicated)."""
    dim = layout(shape, len(devices))
    return list(xs) if dim is None else D.all_gather(xs, dim, devices)


def add_partial(xs, ys, devices) -> list:
    """`x + sum(ys)` in the boundary layout: the partial sums `ys` (full
    shape at each position) reduce-scattered onto the layout, then added."""
    dim = layout(ys[0].shape, len(devices))
    red = D.all_reduce(ys, devices) if dim is None \
        else D.reduce_scatter(ys, dim, devices)
    return [x + y for x, y in zip(xs, red)]


def normed(xs, w, shape, cfg: ModelConfig, devices) -> list:
    """rmsnorm of a boundary-layout row tensor, replicated: a sequence
    block is normed where it lies and then gathered; a d_model block is
    gathered first (the norm's mean runs over d_model)."""
    if layout(shape, len(devices)) == 2:
        xs = gathered(xs, shape, devices)
        return [L.rmsnorm(x, wm.to(x.dtype), cfg.norm_eps)
                for x, wm in zip(xs, w)]
    hs = [L.rmsnorm(x, wm.to(x.dtype), cfg.norm_eps) for x, wm in zip(xs, w)]
    return gathered(hs, shape, devices)


def by_position(p_row, nm: int) -> list:
    """A tree of per-position lists as a list of per-position trees."""
    return [tree_map(lambda ls, m=m: ls[m], p_row) for m in range(nm)]


def unstack_sharded(stacked) -> list:
    """Every layer of a stacked tree of `Sharded`: per layer a tree of
    `Sharded` views of each piece (one `unbind` a piece, as `unstack`)."""
    def layers(t):
        sh = D.NamedSharding(t.sharding.mesh, t.sharding.spec[1:])
        parts = [p.unbind(0) for p in t.pieces]
        return [D.Sharded([ps[i] for ps in parts], sh)
                for i in range(len(parts[0]))]
    per = tree_map(layers, stacked)
    return [tree_map(lambda ls, i=i: ls[i], per)
            for i in range(num_layers(stacked))]


def fsdp_gather(lp, mesh) -> dict:
    """Each leaf of a tree of `Sharded` gathered over the data axes that
    shard it (the FSDP all-gather): per leaf, one tensor per mesh
    position, on its device."""
    return tree_map(lambda t: D.gather_over(t.pieces, t.sharding,
                                            D.dp_axes(mesh)), lp)


def row_params(g, row) -> dict:
    """The per-position lists of `fsdp_gather`'s tree for one data row."""
    return tree_map(lambda ls: [ls[i] for i in row], g)


def dense_block_tp(lp, xs_rows, shape_rows, cfg: ModelConfig, mesh,
                   with_kv: bool = False):
    """One dense layer over the data rows `xs_rows` (each a boundary-
    layout list over its model positions, of full shape
    `shape_rows[r]`). Returns the rows' outputs and, with `with_kv`,
    each row's per-position (k, v)."""
    g = fsdp_gather(lp, mesh)
    outs, kvs = [], []
    for row, xs, shape in zip(mesh.rows(), xs_rows, shape_rows):
        devs = [mesh.flat_devices()[i] for i in row]
        p = row_params(g, row)
        h = normed(xs, p["ln1"], shape, cfg, devs)
        ys, kv = A.attend_train_tp(by_position(p["attn"], len(devs)), h,
                                   cfg)
        xs = add_partial(xs, ys, devs)
        h = normed(xs, p["ln2"], shape, cfg, devs)
        xs = add_partial(xs, L.mlp_apply_tp(p["mlp"], h, cfg, devs), devs)
        outs.append(xs)
        kvs.append(kv if with_kv else None)
    return outs, kvs


def dense_decode_block_tp(lp, xs_rows, caches_rows, pos: int,
                          cfg: ModelConfig, mesh) -> list:
    """One dense layer's decode over the data rows: `xs_rows[r]` the
    replicated (B, 1, D) input at each of row r's model positions,
    `caches_rows[r]` their caches' blocks."""
    g = fsdp_gather(lp, mesh)
    outs = []
    for row, xs, cs in zip(mesh.rows(), xs_rows, caches_rows):
        devs = [mesh.flat_devices()[i] for i in row]
        p = row_params(g, row)
        h = [L.rmsnorm(x, w.to(x.dtype), cfg.norm_eps)
             for x, w in zip(xs, p["ln1"])]
        ys = A.attend_decode_tp(by_position(p["attn"], len(devs)), h, cs,
                                pos, cfg, devs)
        xs = [x + y for x, y in zip(xs, D.all_reduce(ys, devs))]
        h = [L.rmsnorm(x, w.to(x.dtype), cfg.norm_eps)
             for x, w in zip(xs, p["ln2"])]
        ys = L.mlp_apply_tp(p["mlp"], h, cfg, devs)
        outs.append([x + y for x, y in zip(xs, D.all_reduce(ys, devs))])
    return outs
