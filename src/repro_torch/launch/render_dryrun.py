"""Dry-run for the paper's own workload: batched camera requests through
the contribution-aware FLICKER pipeline on the production mesh, as the
reference's `repro/launch/render_dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.render_dryrun \\
        [--multi-pod] [--frames 256] [--res 256] [--gaussians 65536] \\
        [--k-max 2048] [--device cuda]

Frames shard over every mesh axis (pure data-parallel serving: one frame
a position at 256 frames on the single pod); the scene is replicated.
The plan is the reference's (CAT, SMOOTH_FOCUSED, MIXED, `k_max`) on the
default backend ("jnp", unfused), so it reaches none of the port's CUDA
kernels, as the reference's reaches no `pallas_call`.

The reference compiles the batch from shapes alone. The port's lists are
as long as the data makes them (`torch.nonzero` in the compaction), so
the render cannot run on the meta device: it runs for real, on a mesh of
the production shape over one repeated device (`--device`, default
"cuda"; "cpu" on request), each position's frames in turn, each under
the dry-run's counters (`launch.dryrun.counted`): flops
(`torch.utils.flop_counter`: the matmul-class ops only, which the
renderer barely uses), bytes accessed and collectives (none: every frame
stays on its position). A position's temp bytes are its peak over its
frames: on a card, `torch.cuda.max_memory_allocated` after a reset, less
what was allocated before; on the CPU, the counter's live-storage peak.
Argument bytes are the scene (its copy at each position, which a real
mesh holds though repeated devices share one) and the position's
cameras; output bytes its images and `processed_per_pixel` counters.
The printed lines are the reference's, each the maximum over positions.

The scene is `core.gaussians.random_scene` from a CPU generator seeded
with `seed` (the reference's has no data, only shapes), and the cameras
`serving.workloads.trajectory_cameras` at the resolution.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.core.cat import SamplingMode
from repro_torch.core.gaussians import random_scene
from repro_torch.core.precision import MIXED
from repro_torch.core.renderer import (GridConfig, RenderPlan, StreamConfig,
                                       TestConfig)
from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import counted, tensors_of
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.serving.workloads import trajectory_cameras


def make_plan(res: int, k_max: int) -> RenderPlan:
    return RenderPlan(
        grid=GridConfig(height=res, width=res),
        test=TestConfig(method="cat", mode=SamplingMode.SMOOTH_FOCUSED,
                        precision=MIXED),
        stream=StreamConfig(k_max=k_max))


def make_inputs(frames: int, res: int, n: int, device, seed: int = 0):
    """(scene, one camera a frame), on `device`."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    scene = random_scene(gen, n, device=device)
    cams = [c.to(device) for c in trajectory_cameras(frames, width=res,
                                                     height=res)]
    return scene, cams


def _scene_tensors(scene) -> list:
    return [scene.means, scene.log_scales, scene.quats,
            scene.opacity_logits, scene.colors]


def _camera_tensors(cam) -> list:
    return [cam.R_wc, cam.t_wc, cam.fx, cam.fy, cam.cx, cam.cy]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def render_position(plan: RenderPlan, scene, cams: list) -> tuple:
    """One position's frames: (images, processed_per_pixel counters)."""
    images, ppp = [], []
    for cam in cams:
        out, counters = plan.render_with_stats(scene, cam)
        images.append(out.image)
        ppp.append(counters["processed_per_pixel"])
    return images, ppp


def run(plan: RenderPlan, scene, cams: list, mesh, *, keep=(),
        positions=None) -> dict:
    """Every position's frames under the counters (or only those of the
    flat `positions`, a sample). Returns the per-position records
    (flops, bytes_accessed, temp/argument/output bytes, collective
    bytes), their maxima, and the frames of the positions in `keep`
    (position -> (images, processed_per_pixel))."""
    n = mesh.size
    if len(cams) % n:
        raise ValueError(f"{len(cams)} frames do not divide over the "
                         f"{n} positions of the mesh")
    per = len(cams) // n
    scene_b = _nbytes(_scene_tensors(scene))
    rows, kept = [], {}
    t0 = time.perf_counter()
    for i, dev in enumerate(mesh.flat_devices()):
        if positions is not None and i not in positions:
            continue
        s = scene.to(dev)
        cs = [c.to(dev) for c in cams[i * per:(i + 1) * per]]
        args = _scene_tensors(s) + [t for c in cs for t in _camera_tensors(c)]
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with counted(args) as sc:
            images, ppp = render_position(plan, s, cs)
            peak = sc.peak
        if on_card:
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
        coll = RL.collective_bytes(sc.records)
        rows.append(dict(
            flops=sc.flops, bytes_accessed=sc.bytes_accessed,
            temp_bytes=peak,
            argument_bytes=scene_b + _nbytes(
                [t for c in cs for t in _camera_tensors(c)]),
            output_bytes=_nbytes(tensors_of([images, ppp])),
            collective_bytes=coll["total_bytes"], position=i))
        if i in keep:
            kept[i] = (images, ppp)
        del images, ppp, s, cs, args
    worst = {k: max(r[k] for r in rows) for k in rows[0] if k != "position"}
    worst["peak_bytes"] = max(r["temp_bytes"] + r["argument_bytes"]
                              for r in rows)
    return dict(positions=rows, max=worst, frames_per_position=per,
                wall_s=time.perf_counter() - t0, kept=kept)


def report(res: dict, frames: int, size: int, n: int, mesh) -> None:
    """The reference's lines, each the maximum over positions."""
    m = res["max"]
    print(f"flicker-render x {frames} frames @ {size}^2, N={n}, "
          f"mesh={dict(mesh.shape)}")
    print(f"  peak={m['peak_bytes'] / 2**30:.2f} GiB/dev  "
          f"flops/dev={m['flops']:.3e} bytes/dev={m['bytes_accessed']:.3e} "
          f"coll={m['collective_bytes']:.3e}")
    print(f"  memory: argument={m['argument_bytes']} "
          f"output={m['output_bytes']} temp={m['temp_bytes']} "
          f"peak={m['peak_bytes']} (bytes, busiest position)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--gaussians", type=int, default=65536)
    ap.add_argument("--k-max", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="the device every mesh position repeats "
                    "(default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"render_dryrun: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 2
    n = 512 if args.multi_pod else 256
    mesh = make_production_mesh(multi_pod=args.multi_pod, devices=[dev] * n)
    plan = make_plan(args.res, args.k_max)
    scene, cams = make_inputs(args.frames, args.res, args.gaussians, dev)
    res = run(plan, scene, cams, mesh)
    report(res, args.frames, args.res, args.gaussians, mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
