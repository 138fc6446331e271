#!/usr/bin/env python
"""How many tiles' Stage-1 candidate sets change between consecutive frames
of the port's hd1080 scene, by orbit step.

    python tools/torch_fingerprint_reuse.py [--device cpu]

Draws the hd1080 workload scene (`repro_torch.serving.workloads`: 2**19
Gaussians of `HD_SCENE_KW` from the seeded generator), projects it for
three frames of `trajectory_cameras` at each orbit step (2π/64, the
trajectory's default, down to a static pose), and compares consecutive
frames' per-tile fingerprints (`core.coherence.tile_fingerprints`, O(N + T)
work). Prints, per step: the camera delta, the share of tiles whose
fingerprint changed (the tiles `render_incremental` would recompact, before
its capacity rule), and the mean and largest candidate count per tile. The
counts are the same on any device; the script runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.core import camera_delta, project, random_scene  # noqa: E402
from repro_torch.core import tile_fingerprints  # noqa: E402
from repro_torch.core.culling import TileGrid  # noqa: E402
from repro_torch.serving.workloads import (HD1080_GAUSSIANS,  # noqa: E402
                                           HD1080_HEIGHT, HD1080_SEED,
                                           HD1080_WIDTH, HD_SCENE_KW,
                                           trajectory_cameras)

STEPS = (("2pi/64", 2 * math.pi / 64), ("2pi/1024", 2 * math.pi / 1024),
         ("2pi/16384", 2 * math.pi / 16384),
         ("2pi/65536", 2 * math.pi / 65536),
         ("2pi/262144", 2 * math.pi / 262144), ("0", 0.0))
FRAMES = 3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args().device)
    gen = torch.Generator(device="cpu").manual_seed(HD1080_SEED)
    scene = random_scene(gen, HD1080_GAUSSIANS, **HD_SCENE_KW).to(device)
    grid = TileGrid(HD1080_HEIGHT, HD1080_WIDTH)
    t = grid.num_tiles
    for label, step in STEPS:
        cams = trajectory_cameras(FRAMES, width=HD1080_WIDTH,
                                  height=HD1080_HEIGHT, step=step)
        fps = [tile_fingerprints(project(scene, c.to(device)), grid)
               for c in cams]
        changed = [int((a[0] != b[0]).any(dim=1).sum())
                   for a, b in zip(fps, fps[1:])]
        counts = fps[0][1]
        shares = ", ".join(f"{100 * c / t:.1f}%" for c in changed)
        print(f"step {label}: camera delta "
              f"{camera_delta(cams[0], cams[1]):.6g}, tiles changed "
              f"{changed} of {t} ({shares}); candidates per tile mean "
              f"{float(counts.double().mean()):.1f}, max "
              f"{int(counts.max())}, {int((counts > 0).sum())} non-empty "
              "tiles", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
