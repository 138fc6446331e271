#!/usr/bin/env python
"""Trace smoke of the PyTorch port: render one SPILL frame with tracing on
and check the span tree the observability layer promises.

Checks (exit non-zero on any failure):
  * span tree shape: render -> preprocess, stage1_compact, ctu[pass=i] and
    blend[pass=i] for every spill pass, finalize — in stage order
  * `plan_first_call` flips True -> False across two renders of one plan
  * on the warm (second) render, the stage walls sum to within 10% of the
    end-to-end render span wall
  * per-pass ctu `vru_pairs` attributions sum to the frame's counter
  * the Chrome trace export is valid JSON with one event per span

    python tools/torch_trace_smoke.py [--out PATH] [--device cpu]

Renders on `--device` (default cuda; with cuda and no CUDA device it exits
2 without running). The scene is drawn from torch.Generator seed 0.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (MIXED, GridConfig, OverflowPolicy,  # noqa: E402
                              RasterConfig, Renderer, SamplingMode,
                              StreamConfig, TestConfig, default_camera,
                              random_scene)
from repro_torch.obs import Tracer, use_tracer, write_chrome_trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "torch_trace_smoke.json"),
                    help="Chrome trace output path")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"trace_smoke: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "render on the CPU", file=sys.stderr)
        return 2

    failures = []

    def check(ok: bool, msg: str):
        print(("ok  " if ok else "FAIL") + f" {msg}")
        if not ok:
            failures.append(msg)

    scene = random_scene(torch.Generator().manual_seed(0), args.n,
                         scale_range=(-2.6, -2.1), stretch=4.0,
                         opacity_range=(-2.0, 3.5), device=dev)
    cam = default_camera(args.res, args.res, device=dev)
    renderer = Renderer(
        grid=GridConfig(args.res, args.res),
        test=TestConfig(method="cat", mode=SamplingMode.SMOOTH_FOCUSED,
                        precision=MIXED),
        stream=StreamConfig(k_max=64, overflow=OverflowPolicy.SPILL,
                            max_spill_passes=4),
        raster=RasterConfig())

    tracer = Tracer()
    with use_tracer(tracer):
        renderer.render_with_stats(scene, cam)          # cold
        out, counters = renderer.render_with_stats(scene, cam)  # warm
    roots = tracer.roots

    check(len(roots) == 2 and all(r.name == "render" for r in roots),
          f"two render roots (got {[r.name for r in roots]})")
    cold, warm = roots
    check(cold.attrs.get("plan_first_call") is True,
          "cold render has plan_first_call=True")
    check(warm.attrs.get("plan_first_call") is False,
          "warm render has plan_first_call=False")

    n_passes = int(warm.attrs.get("n_passes", 0))
    check(n_passes >= 2, f"SPILL plan used >= 2 passes (got {n_passes})")

    names = [c.name for c in warm.children]
    expect = (["preprocess", "stage1_compact"]
              + ["ctu"] * n_passes + ["blend"] * n_passes + ["finalize"])
    check(names == expect, f"stage order {expect} (got {names})")
    for stage in ("ctu", "blend"):
        idx = [c.attrs.get("pass") for c in warm.children
               if c.name == stage]
        check(idx == list(range(n_passes)),
              f"{stage} pass indices 0..{n_passes - 1} (got {idx})")

    stage_wall = sum(c.wall_s for c in warm.children)
    ratio = stage_wall / max(warm.wall_s, 1e-12)
    check(0.9 <= ratio <= 1.0 + 1e-6,
          f"stage walls sum to {100 * ratio:.1f}% of render wall "
          "(need >= 90%)")

    vru = sum(c.attrs.get("vru_pairs", 0.0) for c in warm.children
              if c.name == "ctu")
    total = float(counters["vru_pairs"])
    check(abs(vru - total) <= 1e-3 * max(total, 1.0),
          f"per-pass ctu vru_pairs sum {vru} == counter {total}")

    write_chrome_trace(tracer, args.out)
    with open(args.out) as f:
        trace = json.load(f)
    n_spans = sum(1 for r in roots for _ in r.walk())
    events = trace.get("traceEvents", [])
    check(len(events) == n_spans and
          all(e.get("ph") == "X" for e in events),
          f"Chrome trace has {n_spans} complete events "
          f"(got {len(events)})")
    print(f"wrote {args.out}")

    if failures:
        print(f"\n{len(failures)} check(s) FAILED", file=sys.stderr)
        return 1
    print("\nall checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
