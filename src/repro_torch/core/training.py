"""Differentiable 3DGS training: fit a GaussianScene to target images.

The paper trains scenes with vanilla 3DGS for 30K iters then prunes +
fine-tunes 3K. Offline (no datasets) we fit synthetic targets; the training
loop is the real thing: L1 + (1-SSIM) loss, Adam with per-param-group LRs,
exponential position-LR decay, autograd through the full tile rasterizer.

Train unfused, serve fused: the gradient runs through the all-"torch" plan
(the differentiable twins of the kernels), and `loss_fn` refuses a plan that
would launch a CUDA kernel, which has no backward (`docs/kernels.md`,
"Differentiability"). The trained scene is then served through any plan.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.metrics import ssim
from repro_torch.core.renderer import RenderPlan, as_plan

SCENE_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianScene))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-3
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_colors: float = 2.5e-2
    lr_decay: float = 0.999      # per-step exponential decay on means LR
    ssim_weight: float = 0.2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-15


class TrainState(NamedTuple):
    scene: GaussianScene
    m: GaussianScene
    v: GaussianScene
    step: torch.Tensor           # () int32


def _leaves(scene: GaussianScene) -> list:
    return [getattr(scene, f) for f in SCENE_FIELDS]


def init_state(scene: GaussianScene) -> TrainState:
    zeros = GaussianScene(*(torch.zeros_like(x) for x in _leaves(scene)))
    return TrainState(scene, zeros, zeros,
                      torch.zeros((), dtype=torch.int32,
                                  device=scene.means.device))


def differentiable_plan(cfg) -> RenderPlan:
    """`as_plan(cfg)`, refused with ValueError where the plan would launch
    a CUDA kernel (the "cuda" CTU backend, K1/K4, or the fused blend, K2):
    the kernels have no backward. On the CPU their wrappers run the plain
    versions, which would train there and then fail on the card."""
    plan = as_plan(cfg)
    why = []
    if plan.test.backend == "cuda":
        why.append('TestConfig.backend="cuda" (the PRTU kernels)')
    if plan.raster.fused:
        why.append("RasterConfig(fused=True) (the fused blend kernel)")
    if why:
        raise ValueError(
            "training differentiates through the all-\"torch\" plan only; "
            + " and ".join(why) + " launch CUDA kernels that have no "
            "backward (docs/kernels.md, \"Differentiability\": train "
            "unfused, serve fused)")
    return plan


def loss_fn(scene: GaussianScene, camera, target: torch.Tensor,
            cfg, ssim_weight: float) -> torch.Tensor:
    """cfg: a legacy RenderConfig, a Renderer, or a RenderPlan — training
    differentiates through whichever staged plan it maps to, which must be
    the all-"torch" one (`differentiable_plan`)."""
    img = differentiable_plan(cfg).render(scene, camera).image
    l1 = torch.mean(torch.abs(img - target))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(img, target))


def _group_lrs(tc: TrainConfig, step):
    decay = tc.lr_decay ** step
    return GaussianScene(
        means=tc.lr_means * decay,
        log_scales=tc.lr_scales,
        quats=tc.lr_quats,
        opacity_logits=tc.lr_opacity,
        colors=tc.lr_colors,
    )


def value_and_grad(scene: GaussianScene, camera, target: torch.Tensor,
                   cfg, ssim_weight: float):
    """(loss, grads): `loss_fn` and its gradient as a GaussianScene, taken
    with respect to fresh leaves of `scene`'s tensors."""
    params = [x.detach().requires_grad_(True) for x in _leaves(scene)]
    loss = loss_fn(GaussianScene(*params), camera, target, cfg, ssim_weight)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return loss.detach(), GaussianScene(*grads)


def adam_update(state: TrainState, grads: GaussianScene,
                tc: TrainConfig) -> TrainState:
    """The Adam step of `train_step` on handed gradients: nonfinite entries
    count as 0, bias correction at t = step + 1 in float32, the means' LR
    decayed by lr_decay**t. The new scene's leaves require grad."""
    step = state.step + 1
    t = step.to(torch.float32)
    lrs = _group_lrs(tc, t)
    scene, m, v = {}, {}, {}
    with torch.no_grad():
        for f in SCENE_FIELDS:
            p, g = getattr(state.scene, f), getattr(grads, f)
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            m[f] = tc.b1 * getattr(state.m, f) + (1 - tc.b1) * g
            v[f] = tc.b2 * getattr(state.v, f) + (1 - tc.b2) * g * g
            mh = m[f] / (1 - tc.b1 ** t)
            vh = v[f] / (1 - tc.b2 ** t)
            new = p - getattr(lrs, f) * mh / (torch.sqrt(vh) + tc.eps)
            scene[f] = new.requires_grad_(True)
    return TrainState(GaussianScene(**scene), GaussianScene(**m),
                      GaussianScene(**v), step)


def train_step(state: TrainState, camera, target: torch.Tensor,
               cfg, tc: TrainConfig):
    """One Adam step on all Gaussian parameter groups. Returns (state, loss)."""
    loss, grads = value_and_grad(state.scene, camera, target, cfg,
                                 tc.ssim_weight)
    return adam_update(state, grads, tc), loss


def fit(scene: GaussianScene, camera, target: torch.Tensor,
        cfg, tc: TrainConfig | None = None, steps: int = 200, *,
        fault=None):
    """Fit `scene` to `target` from one view. Returns (scene, losses), the
    losses a (steps,) float32 tensor.

    fault: an optional `distributed.fault.FaultManager`. The run then
    resumes from its latest checkpoint (the losses then cover only the
    steps run in this call) and offers it the state after every step.
    """
    tc = tc or TrainConfig()
    state, start = init_state(scene), 0
    if fault is not None:
        state, start = fault.restore_latest(state)
    losses = []
    for _ in range(start, steps):
        state, loss = train_step(state, camera, target, cfg, tc)
        losses.append(loss)
        if fault is not None:
            fault.maybe_save(int(state.step), state)
    losses = (torch.stack(losses).to(torch.float32) if losses else
              torch.zeros((0,), dtype=torch.float32,
                          device=scene.means.device))
    return state.scene, losses
