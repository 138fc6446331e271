"""Train, prefill and decode step builders, as the library half of the
reference's `repro/launch/steps.py` (its lines 68-133).

The port's `Model` holds its parameters, so a step reads and updates the
module's own: `make_train_step(model, opt_cfg)` returns
`train_step(opt_state, batch) -> (opt_state, metrics)`, which leaves the
updated parameters in `model` (copied in place, so the model serves what
it trained). `mesh` must be None or a one-device mesh; the sharding half
of the reference's file (`batch_shardings`, `opt_shardings`,
`adafactor_shardings`, `cache_shardings`, `jit_*`) needs the LM's axis
rules and comes with the LM mesh slice.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, check_mesh
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


def grads_of(model: Model, batch: dict, leaves: list):
    """(loss, the gradient of `model.loss(batch)` for each of `leaves`);
    a parameter the loss does not reach gets zeros, as jax's grad."""
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def make_train_step(model: Model, opt_cfg, mesh=None, *, opt=None,
                    microbatches=None, grad_transform=None):
    """Train step with gradient accumulation over `cfg.microbatches`: the
    batch is split along its first axis, each microbatch's gradient is
    taken in order and summed from zeros in the accumulation dtype
    (`moment_dtype`), then divided by their number, as the reference's
    `scan`. The optimizer (`cfg.optimizer`) then updates the parameters,
    which replace the module's in place.

    A driver that takes its own step, as `launch.train`'s (AdamW on the
    whole batch, compressed), passes the optimizer module `opt`,
    `microbatches` and `grad_transform`, a function from the gradient
    tree to the tree that the optimizer takes."""
    check_mesh(mesh)
    cfg = model.cfg
    opt = opt or _opt_module(cfg)
    nmb = max(1, cfg.microbatches if microbatches is None else microbatches)
    acc_dtype = moment_dtype(cfg)

    def train_step(opt_state, batch):
        model.requires_grad_(True)
        params = model.params()
        leaves = flatten(params)
        if nmb == 1:
            loss, grads = grads_of(model, batch, leaves)
        else:
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(nmb):
                mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(model, mb, leaves)
                grads = [a + b.to(acc_dtype) for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / nmb for g in grads]
            loss = loss / nmb
        with torch.no_grad():
            grads = unflatten(params, list(grads))
            if grad_transform is not None:
                grads = grad_transform(grads)
            new, opt_state, metrics = opt.apply(params, grads, opt_state,
                                                opt_cfg)
            for p, q in zip(leaves, flatten(new)):
                p.copy_(q)
        metrics["loss"] = loss
        return opt_state, metrics
    return train_step


def make_prefill_step(model: Model, mesh=None):
    check_mesh(mesh)

    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model, mesh=None):
    """decode_step(caches, tokens) -> (next tokens (B, 1) int64, caches):
    one greedy step."""
    check_mesh(mesh)

    def decode_step(caches, tokens):
        logits, caches = model.decode_step(caches, tokens)
        return torch.argmax(logits, dim=-1)[:, None], caches
    return decode_step
