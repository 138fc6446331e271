"""End-to-end 3DGS training driver of the PyTorch port: fit a Gaussian
scene to a target image with the differentiable tile rasterizer, then
prune and render it through the FLICKER pipeline — the paper's §V-A flow.

    PYTHONPATH=src python examples/torch_train_gaussians.py [--steps 200] \\
        [--device cpu]

Trains on `--device` (default cuda; with cuda and no CUDA device it exits
2 without running). The scene is drawn from torch.Generator seed 0. The
fit and the pruned render run the plain PyTorch plan: the kernels have no
backward.
"""
import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.core import (FULL_FP32, MIXED, RenderConfig, SamplingMode,
                              TileGrid, default_camera, psnr, random_scene,
                              render_with_stats, ssim)
from repro_torch.core.pruning import contribution_scores, prune
from repro_torch.core.training import TrainConfig, fit


def target_image(size: int, device="cpu") -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) / size
    y, x = torch.meshgrid(r, r, indexing="ij")
    img = torch.stack([
        0.5 + 0.45 * torch.sin(4 * x + 2 * y),
        0.5 + 0.45 * torch.cos(3 * y),
        0.5 + 0.45 * torch.sin(5 * x * y + 1.0),
    ], -1)
    return torch.clamp(img, 0, 1)


def main(argv=None, report=None) -> int:
    """report: optional dict that receives `losses` (the fit's, a list),
    `n`, `n_pruned`, `psnr_base`, `ssim_base`, `psnr`, `ssim` and
    `work_px` (the pruned scene's, under FLICKER's config)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--gaussians", type=int, default=600)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"train_gaussians: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "train on the CPU", file=sys.stderr)
        return 2

    cam = default_camera(args.size, args.size, device=dev)
    gt = target_image(args.size, dev)
    cfg = RenderConfig(height=args.size, width=args.size, method="aabb",
                       precision=FULL_FP32, k_max=args.gaussians)

    scene0 = random_scene(torch.Generator().manual_seed(0), args.gaussians,
                          scale_range=(-2.8, -2.0), opacity_range=(-1, 1),
                          device=dev)
    print(f"fitting {args.gaussians} Gaussians for {args.steps} steps ...")
    t0 = time.perf_counter()
    scene, losses = fit(scene0, cam, gt, cfg, TrainConfig(),
                        steps=args.steps)
    losses = losses.tolist()
    print(f"  {time.perf_counter()-t0:.1f}s; loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}")

    with torch.no_grad():
        base = render_with_stats(scene, cam, cfg)[0].image
        q_base, s_base = float(psnr(base, gt)), float(ssim(base, gt))
        print(f"base:  PSNR {q_base:.2f}  SSIM {s_base:.3f}")

        scores = contribution_scores(scene, [cam],
                                     TileGrid(args.size, args.size),
                                     k_max=args.gaussians)
        pscene, _ = prune(scene, scores, keep_frac=0.6)
        fcfg = dataclasses.replace(cfg, method="cat",
                                   mode=SamplingMode.SMOOTH_FOCUSED,
                                   precision=MIXED)
        ours, counters = render_with_stats(pscene, cam, fcfg)
    q, s = float(psnr(ours.image, gt)), float(ssim(ours.image, gt))
    work = float(counters["processed_per_pixel"])
    print(f"prune->flicker ({pscene.n} Gaussians): PSNR {q:.2f}  "
          f"SSIM {s:.3f}  work/px {work:.1f}")
    if report is not None:
        report.update(losses=losses, n=scene.n, n_pruned=pscene.n,
                      psnr_base=q_base, ssim_base=s_base, psnr=q, ssim=s,
                      work_px=work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
