"""LM training driver: any --arch, fault-tolerant, restartable, as the
reference's `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu

Runs on `--device` (default "cuda"; with "cuda" and no CUDA device the
driver exits 2 without running) over a one-device mesh. Like the
reference's driver it always builds AdamW, takes each step on the whole
batch (no microbatches), applies `--compress` with error feedback, saves
(params, opt_state) every `--save-every` steps through a `FaultManager`
(and on SIGTERM, then exits cleanly), resumes from the latest checkpoint
with the optimizer's step set to it, and flags straggler steps. The data
is `data.tokens.synthetic_batch` of (seed 0, step), so a resumed run
sees the batches an uninterrupted one would. `--production-mesh` and
`--multi-pod` build `launch.mesh.make_production_mesh` (16 x 16, or 2 x
16 x 16 devices) over the visible CUDA devices, which raises ValueError
with the count on a machine with fewer; on such a mesh the model is
placed by the sharding rules, the step runs sharded, and checkpoints
hold the gathered state.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import tokens as data
from repro_torch.distributed.fault import (FaultConfig, FaultManager,
                                           StragglerMonitor)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import lm_model
from repro_torch.launch.steps import (_tensors, make_train_step,
                                     moment_dtype)
from repro_torch.models.model import Model, is_sharded
from repro_torch.optim import adamw
from repro_torch.optim.compression import (CompressionConfig, apply_tree,
                                           init_residuals)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    # `serve.lm_model` builds the model; training keeps the arch's dtype.
    ap.set_defaults(param_dtype=None)
    return ap


def mesh_of(args):
    """The production mesh under `--production-mesh` / `--multi-pod`
    (ValueError with the device count where there are too few), else
    None (one device)."""
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod)
    return None


def make_step(model: Model, opt_cfg, comp_cfg):
    """The driver's step, as the reference's: one AdamW update from the
    gradient of the whole batch (no microbatches), compressed with error
    feedback when `comp_cfg.kind` is not "none" (the residuals live in
    the step). step(opt_state, batch) -> (opt_state, metrics)."""
    transform = None
    if comp_cfg.kind != "none" and is_sharded(model.mesh):
        raise ValueError("--compress runs on one device; the sharded "
                         "step takes uncompressed gradients")
    if comp_cfg.kind != "none":
        residuals = init_residuals(model.params())

        def transform(grads):
            nonlocal residuals
            grads, residuals = apply_tree(grads, residuals, comp_cfg)
            return grads
    return make_train_step(model, opt_cfg, opt=adamw, microbatches=1,
                           grad_transform=transform)


def opt_config(args, cfg) -> adamw.AdamWConfig:
    """The driver's AdamW: warmup over the first tenth of `--steps`, cosine
    decay to its end."""
    return adamw.AdamWConfig(
        lr=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        moment_dtype=moment_dtype(cfg))


def run(args, log=print, fault_manager=None, model=None) -> dict:
    """The training loop on `model` (default `lm_model(args)`),
    checkpointed through `fault_manager` (default: a `FaultManager` on
    `--ckpt-dir` saving every `--save-every` steps). Returns dict(model,
    opt_state, metrics (one dict of floats per step run), step_ms (each
    step's wall), start, stopped (True on preemption), monitor)."""
    mesh = mesh_of(args)
    model = model if model is not None else lm_model(args, mesh)
    cfg, dev = model.cfg, model.device
    shape = ShapeConfig("custom", "train", args.seq, args.batch)
    opt_cfg = opt_config(args, cfg)
    comp_cfg = CompressionConfig(kind=args.compress)

    params = model.params()
    opt_state = adamw.init(params, opt_cfg)

    fm = fault_manager or FaultManager(FaultConfig(
        ckpt_dir=args.ckpt_dir, save_every=args.save_every))
    (restored, opt_state), start = fm.restore_latest((params, opt_state))
    if start:
        with torch.no_grad():
            for p, q in zip(_tensors(flatten(params)),
                            _tensors(flatten(restored))):
                p.copy_(q)
        opt_state = opt_state._replace(step=torch.tensor(
            start, dtype=torch.int32, device=dev))
        log(f"restored checkpoint at step {start}")

    train_step = make_step(model, opt_cfg, comp_cfg)
    mon = StragglerMonitor()
    history, step_ms = [], []
    stopped = False
    for step in range(start, args.steps):
        mon.step_start(step)
        batch = data.synthetic_batch(cfg, shape, step, device=dev)
        opt_state, metrics = train_step(opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        history.append(metrics)
        straggle = mon.step_end()
        step_ms.append(mon.times[-1] * 1e3)
        if step % 10 == 0 or step == args.steps - 1:
            log(f"step {step:5d} loss={metrics['loss']:.4f} "
                f"gnorm={metrics['grad_norm']:.3f} "
                f"lr={metrics['lr']:.2e}"
                + ("  [straggler]" if straggle else ""))
        fm.maybe_save(step + 1, (params, opt_state))
        if fm.preempted:
            log("preemption: checkpoint saved, exiting cleanly")
            stopped = True
            break
    if not stopped:
        log(f"done; median step {mon.median * 1e3:.1f} ms, "
            f"{len(mon.flagged)} straggler steps")
    return dict(model=model, opt_state=opt_state, metrics=history,
                step_ms=step_ms, start=start, stopped=stopped, monitor=mon)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        # No fallback to the CPU.
        print(f"train: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "train on the CPU", file=sys.stderr)
        return 2
    run(args, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
