"""Train, prefill and decode step builders and their placements over a
mesh, as the reference's `repro/launch/steps.py`.

The port's `Model` holds its parameters, so a step reads and updates the
module's own: `make_train_step(model, opt_cfg)` returns
`train_step(opt_state, batch) -> (opt_state, metrics)`, which leaves the
updated parameters in `model` (copied in place, so the model serves what
it trained). `mesh` is None or the model's own mesh; over a mesh of more
than one position (the dense family) the parameters and the moments are
`Sharded`, each microbatch is split over the data rows inside
`model.loss`, and the optimizer sums replicated gradients before its
update (`optim.adamw`).

The placements (`batch_shardings`, `opt_shardings`,
`adafactor_shardings`, `cache_shardings`) are the reference's, as
`distributed.sharding.NamedSharding`s. `jit_train_step`,
`jit_prefill_step` and `jit_decode_step` keep the reference's names for
a reader who looks for them, but nothing is compiled: each returns the
step bound to the mesh's placements (`Step`) and its example arguments
as meta tensors with their placements (`MetaArg`), for the dry-runs.
Adafactor's placements are given; running it on shards comes with the
MoE mesh slice (arctic, the one arch that uses it, is MoE).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as D
from repro_torch.distributed.sharding import NamedSharding, Sharded
from repro_torch.models import pspec
from repro_torch.models.model import Model, check_mesh, is_sharded
from repro_torch.models.pspec import PSpec
from repro_torch.optim import adafactor, adamw


def _opt_module(cfg: ModelConfig):
    return adafactor if cfg.optimizer == "adafactor" else adamw


def moment_dtype(cfg: ModelConfig) -> torch.dtype:
    """AdamW's moment dtype and the gradients' accumulation dtype: bf16
    when `cfg.moment_dtype` says so, else float32."""
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def make_opt_cfg(cfg: ModelConfig, lr: float = 3e-4):
    if cfg.optimizer == "adafactor":
        return adafactor.AdafactorConfig(lr=lr)
    return adamw.AdamWConfig(lr=lr, moment_dtype=moment_dtype(cfg))


# --- placements ---------------------------------------------------------------

def batch_rule(b: int, mesh) -> Any:
    """The batch dimension's mesh axes: every data axis when they divide
    `b` and b > 1, else None (replicated)."""
    return D.dp_axes(mesh) if b % D.dp_size(mesh) == 0 and b > 1 else None


def batch_shardings(model: Model, shape: ShapeConfig, mesh) -> dict:
    """A NamedSharding per batch leaf: the batch over the data axes by
    `batch_rule`, the rest replicated."""
    return {k: NamedSharding(mesh, (batch_rule(v.shape[0], mesh),)
                             + (None,) * (v.dim() - 1))
            for k, v in model.input_specs(shape).items()}


def opt_shardings(model: Model, mesh) -> adamw.OptState:
    """Adam's m and v are placed as their parameters."""
    s = pspec.shardings(model.specs(), mesh, model.cfg.fsdp_over_pod)
    return adamw.OptState(m=s, v=s, step=NamedSharding(mesh, ()))


def adafactor_shardings(model: Model, mesh, cfg) -> adafactor.AdafactorState:
    """Factored moments: row and col inherit the parameter's leading
    logical axes; an unfactored moment is placed as its parameter."""
    fop = model.cfg.fsdp_over_pod

    def one(p: PSpec):
        if adafactor._should_factor(p.shape, cfg):
            return adafactor.FactoredMoment(
                row=NamedSharding(mesh, D.resolve(p.logical[:-1], mesh,
                                                  fop)),
                col=NamedSharding(mesh, D.resolve(
                    p.logical[:-2] + p.logical[-1:], mesh, fop)),
                full=NamedSharding(mesh, ()))
        return adafactor.FactoredMoment(
            row=NamedSharding(mesh, ()), col=NamedSharding(mesh, ()),
            full=NamedSharding(mesh, D.resolve(p.logical, mesh, fop)))

    return adafactor.AdafactorState(v=pspec.tree_map(one, model.specs()),
                                    step=NamedSharding(mesh, ()))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def cache_shardings(model: Model, batch: int, seq: int, mesh):
    """A NamedSharding per leaf of `model.cache_logical(batch)` (the
    caches' structure; `pos` replicated)."""
    def conv(x):
        if _is_logical(x):
            return NamedSharding(mesh, D.resolve(x, mesh))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tuple(conv(v) for v in x)
    return conv(model.cache_logical(batch))


# --- steps --------------------------------------------------------------------

def _check_step_mesh(model: Model, mesh) -> None:
    check_mesh(mesh, model.cfg)
    if is_sharded(mesh) and mesh is not model.mesh:
        raise ValueError("a step over a mesh runs on the model's own mesh; "
                         "build the Model with mesh=")


def grads_of(model: Model, batch: dict, leaves: list):
    """(loss, the gradient of `model.loss(batch)` for each of `leaves`);
    a parameter the loss does not reach gets zeros, as jax's grad."""
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def _tensors(leaves: list) -> list:
    """The tensors of a leaf list: a `Sharded` leaf's pieces in order."""
    return [p for x in leaves
            for p in (x.pieces if isinstance(x, Sharded) else [x])]


def _repack(leaves: list, tensors: list) -> list:
    """`tensors` (as `_tensors` lists them) regrouped like `leaves`."""
    it = iter(tensors)
    return [Sharded([next(it) for _ in x.pieces], x.sharding)
            if isinstance(x, Sharded) else next(it) for x in leaves]


def make_train_step(model: Model, opt_cfg, mesh=None, *, opt=None,
                    microbatches=None, grad_transform=None):
    """Train step with gradient accumulation over `cfg.microbatches`: the
    batch is split along its first axis, each microbatch's gradient is
    taken in order and summed from zeros in the accumulation dtype
    (`moment_dtype`), then divided by their number, as the reference's
    `scan`. The optimizer (`cfg.optimizer`) then updates the parameters,
    which replace the module's in place. Over a mesh each microbatch is
    split over the data rows (`Model.loss`).

    A driver that takes its own step, as `launch.train`'s (AdamW on the
    whole batch, compressed), passes the optimizer module `opt`,
    `microbatches` and `grad_transform`, a function from the gradient
    tree to the tree that the optimizer takes."""
    _check_step_mesh(model, mesh)
    cfg = model.cfg
    opt = opt or _opt_module(cfg)
    if opt is adafactor and is_sharded(model.mesh):
        raise NotImplementedError(
            "Adafactor on sharded parameters (its row and column means over "
            "sharded dimensions) comes with the MoE mesh slice")
    nmb = max(1, cfg.microbatches if microbatches is None else microbatches)
    acc_dtype = moment_dtype(cfg)

    def train_step(opt_state, batch):
        model.requires_grad_(True)
        params = model.params()
        leaves = flatten(params)
        tensors = _tensors(leaves)
        if nmb == 1:
            loss, grads = grads_of(model, batch, tensors)
        else:
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in tensors]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(nmb):
                mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(model, mb, tensors)
                grads = [a + b.to(acc_dtype) for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / nmb for g in grads]
            loss = loss / nmb
        with torch.no_grad():
            grads = unflatten(params, _repack(leaves, list(grads)))
            if grad_transform is not None:
                grads = grad_transform(grads)
            new, opt_state, metrics = opt.apply(params, grads, opt_state,
                                                opt_cfg)
            for p, q in zip(tensors, _tensors(flatten(new))):
                p.copy_(q)
        metrics["loss"] = loss
        return opt_state, metrics
    return train_step


def make_prefill_step(model: Model, mesh=None):
    _check_step_mesh(model, mesh)

    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model, mesh=None):
    """decode_step(caches, tokens) -> (next tokens (B, 1) int64, caches):
    one greedy step."""
    _check_step_mesh(model, mesh)

    def decode_step(caches, tokens):
        logits, caches = model.decode_step(caches, tokens)
        return torch.argmax(logits, dim=-1)[:, None], caches
    return decode_step


# --- bound steps (the reference's jit_* entry points) ------------------------

@dataclasses.dataclass
class Step:
    """A step bound to its mesh's placements: `in_shardings` and
    `out_shardings` as the reference's `jax.jit` takes them. The first
    call builds the step (`build()`, which needs a model placed on that
    mesh) and runs it; nothing is compiled, so the placements can be read
    for any model, a "meta" one included."""
    build: Callable
    in_shardings: tuple
    out_shardings: Any
    fn: Callable = None

    def __call__(self, *args):
        if self.fn is None:
            self.fn = self.build()
        return self.fn(*args)


class MetaArg(NamedTuple):
    """An example argument: a tensor on the "meta" device (shape and
    dtype, no data) and its placement."""
    value: torch.Tensor
    sharding: NamedSharding


def _meta(shape, dtype, sharding) -> MetaArg:
    return MetaArg(torch.empty(shape, dtype=dtype, device="meta"), sharding)


def _abstract_params(model: Model, p_shard) -> dict:
    dt = torch.bfloat16 if model.cfg.param_dtype == "bfloat16" \
        else torch.float32
    return D.map_with(lambda p, s: _meta(p.shape, dt, s),
                      model.specs(), p_shard)


def jit_train_step(model: Model, opt_cfg, mesh, shape: ShapeConfig):
    """The train step bound to `mesh` and its example arguments
    (params, optimizer state, batch) as `MetaArg`s (nothing compiled)."""
    p_shard = pspec.shardings(model.specs(), mesh, model.cfg.fsdp_over_pod)
    if model.cfg.optimizer == "adafactor":
        if not isinstance(opt_cfg, adafactor.AdafactorConfig):
            opt_cfg = adafactor.AdafactorConfig(lr=getattr(opt_cfg, "lr",
                                                           3e-4))
        o_shard = adafactor_shardings(model, mesh, opt_cfg)
    else:
        o_shard = opt_shardings(model, mesh)
    b_shard = batch_shardings(model, shape, mesh)
    step = Step(lambda: make_train_step(model, opt_cfg, mesh),
                in_shardings=(p_shard, o_shard, b_shard),
                out_shardings=(p_shard, o_shard, None))
    params_abs = _abstract_params(model, p_shard)
    opt = _opt_module(model.cfg)
    state = opt.init(pspec.tree_map(lambda a: a.value, params_abs), opt_cfg)
    opt_abs = D.map_with(lambda x, s: MetaArg(x, s), state, o_shard)
    batch_abs = {k: MetaArg(v, b_shard[k])
                 for k, v in model.input_specs(shape).items()}
    return step, (params_abs, opt_abs, batch_abs)


def jit_prefill_step(model: Model, mesh, shape: ShapeConfig):
    """The prefill step bound to `mesh`; example (params, batch)."""
    p_shard = pspec.shardings(model.specs(), mesh, model.cfg.fsdp_over_pod)
    b_shard = batch_shardings(model, shape, mesh)
    step = Step(lambda: make_prefill_step(model, mesh),
                in_shardings=(p_shard, b_shard), out_shardings=None)
    batch_abs = {k: MetaArg(v, b_shard[k])
                 for k, v in model.input_specs(shape).items()}
    return step, (_abstract_params(model, p_shard), batch_abs)


def jit_decode_step(model: Model, mesh, shape: ShapeConfig):
    """The greedy decode step bound to `mesh`; example (params, caches,
    tokens)."""
    b = shape.global_batch
    p_shard = pspec.shardings(model.specs(), mesh, model.cfg.fsdp_over_pod)
    c_shard = cache_shardings(model, b, shape.seq_len, mesh)
    t_shard = NamedSharding(mesh, (batch_rule(b, mesh), None))
    step = Step(lambda: make_decode_step(model, mesh),
                in_shardings=(p_shard, c_shard, t_shard),
                out_shardings=(t_shard, c_shard))
    caches = model.init_caches(b, shape.seq_len, device="meta")
    caches_abs = D.map_with(
        lambda x, s: MetaArg(x, s) if torch.is_tensor(x) else x,
        caches, c_shard)
    tok_abs = _meta((b, 1), torch.int64, t_shard)
    return step, (_abstract_params(model, p_shard), caches_abs, tok_abs)

