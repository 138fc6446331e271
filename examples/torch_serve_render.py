"""Serving-engine quickstart of the PyTorch port: a mixed multi-scene
request stream (two scenes, two resolutions, varying batch sizes)
micro-batched through `repro_torch.serving.RenderEngine`, with per-request
latency splits and the machine model's projected FPS on the FLICKER
accelerator.

    PYTHONPATH=src python examples/torch_serve_render.py [--requests 12] \\
        [--pallas] [--device cpu]

`--pallas` runs the CTU's entry CAT on its CUDA kernel (the "cuda" test
backend, csrc/prtu_entry.cu), as `repro_torch.launch.serve --pallas` does.
Serves on `--device` (default cuda; with cuda and no CUDA device it exits
2 without running). Scene i is drawn from torch.Generator seed i.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import Renderer, TestConfig, orbit_camera
from repro_torch.serving import (MicroBatcher, RenderEngine,
                                 register_demo_scenes)


def main(argv=None, report=None) -> int:
    """report: optional dict that receives the `engine` and the requests'
    `results` (one `RequestResult` each, in submission order)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--gaussians", type=int, default=4000)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--pallas", action="store_true",
                    help="run the CTU on its CUDA kernel (K1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"serve_render: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "serve on the CPU", file=sys.stderr)
        return 2

    renderer = Renderer(test=TestConfig(
        backend="cuda" if args.pallas else "torch"))
    engine = RenderEngine(renderer, device=dev, max_batch=args.max_batch)
    scenes_res = (args.res, max(args.res // 2, 16))
    # Probe-driven k_max: measure each scene's Stage-1 survivor bound over
    # a few poses at both served resolutions (pow2-bucketed).
    probes = [orbit_camera(t, r, r)
              for r in scenes_res for t in (0.0, 2.1, 4.2)]
    register_demo_scenes(engine, args.gaussians, probe_cameras=probes)
    batcher = MicroBatcher(engine)

    scenes = engine.scene_names()
    resolutions = scenes_res
    print(f"serving {args.requests} requests over {len(scenes)} scenes x "
          f"{resolutions} px ({'cuda' if args.pallas else 'torch'} CTU) "
          "...")

    futures = []
    for i in range(args.requests):
        # Scene flips every 2 requests, resolution every 2*len(scenes):
        # all combinations occur, and consecutive requests still batch.
        res = resolutions[(i // (2 * len(scenes))) % len(resolutions)]
        futures.append(batcher.submit(
            scenes[(i // 2) % len(scenes)],
            orbit_camera(2 * np.pi * i / args.requests, res, res)))
        if batcher.pending >= args.max_batch:   # serve in micro-batches
            batcher.flush()
    batcher.flush()

    results = [f.result(timeout=0) for f in futures]
    for i, r in enumerate(results):
        print(f"  req {i}: {r.frame.request.scene:>6s} "
              f"{r.image.shape[0]:>3d}px | batch {r.frame.batch_size}"
              f"/bucket {r.frame.bucket_size} | queue "
              f"{r.queue_s*1e3:6.1f} ms + render {r.render_s*1e3:7.1f} ms | "
              f"work/px {float(r.counters['processed_per_pixel']):6.1f}")
    print(engine.telemetry.format_snapshot())
    print(f"({engine.compile_count} plans built; modeled FPS is the "
          f"perf model's FLICKER projection — paper targets real-time >> 60)")
    if report is not None:
        report.update(engine=engine, results=results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
