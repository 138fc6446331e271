"""Readings behind a cell's correctness limits, on the chip, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --frames 4 --first-seed <n> --out <file.json>

For each seed it sets the cell up as a run does, serves `--frames` frames
through the scheduler after the warm-up (the timed path at the timed
sizes), frees the program and compares the frames with the reference: the
program's readings. For the first `--control-seeds` seeds it also renders
the reference in TF32 (every matmul operand rounded to 10 mantissa bits),
put in the program's place: the control's readings. The benchmark's runs do
not run this; `PERF.md` gives the readings and the limits set from them.

    python3 portbench/calibrate.py --workload hd1080.drift-2s --seeds 3 \
        --fault stale --seconds 50 --first-seed <n> --out <file.json>

reads a fault instead: each seed is a whole run of the cell (`harness.run`,
a window of `--seconds`, the harness's own comparison) with the fault
planted under the timed path. `stale`: every session serves its first frame
again, a state that never advances.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import harness, judge, manifest  # noqa: E402
from portbench.reference import render as reference  # noqa: E402


def readings(cell, seed: int, frames: int, control: bool, device) -> dict:
    """The program's numbers for one seed and, with `control`, the TF32
    reference's."""
    system = harness.System(cell, seed, device)
    system.loop(frames=harness.WARM_ROUNDS * len(system.clients))
    kept = []
    system.loop(frames=frames, on_done=lambda d, r: kept.append(
        (d, r.image)))
    k_max, passes = system.k_max, system.passes(cell.config)
    scene = system.scene
    system.close()
    out = dict(seed=seed, k_max=k_max, passes=passes, frames=len(kept))
    prog, ctrl = [], []
    cat = harness.reference_cat(cell.config)
    for done, image in kept:
        cam = harness.reference_camera(done.pose)
        ref, _ = reference.render(scene, cam, cat)
        prog.append(judge.frame_gaps(image, ref))
        if control:
            low, _ = reference.render(scene, cam, cat, "tf32")
            ctrl.append(judge.frame_gaps(low, ref))
    out["program"] = judge.combine(prog)
    out["program_frames"] = prog
    if control:
        out["control"] = judge.combine(ctrl)
        out["control_frames"] = ctrl
    return out


_FIRST: dict = {}             # session -> its first frame, for one run


def plant_stale() -> None:
    """Every session serves its first frame again, whatever its pose."""
    from repro_torch.serving.engine import RenderEngine
    one = RenderEngine._render_incremental_one

    def stale(self, request, *args):
        frame = one(self, request, *args)
        return dataclasses.replace(
            frame, image=_FIRST.setdefault(request.session, frame.image))
    RenderEngine._render_incremental_one = stale


def fault_readings(cell, seed: int, seconds: float, device) -> dict:
    """A whole run's checks with the fault planted."""
    _FIRST.clear()
    result, info = harness.run(cell, seed, seconds, False, device,
                               time.perf_counter())
    return dict(seed=seed, correct=result["correct"],
                checks=result["checks"], frames=[
                    line for line in info if line.startswith(
                        ("window", "reference"))])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fault", choices=("stale",))
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    cell = manifest.cell(harness.ROOT, args.workload)
    device = torch.device("cuda", 0)
    if args.fault == "stale":
        plant_stale()
    rows = []
    for i in range(args.seeds):
        t0 = time.perf_counter()
        if args.fault:
            row = fault_readings(cell, args.first_seed + i, args.seconds,
                                 device)
        else:
            row = readings(cell, args.first_seed + i, args.frames,
                           i < args.control_seeds, device)
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if not k.endswith("_frames")}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(
        workload=args.workload, fault=args.fault, card=harness.card_line(),
        rows=rows),
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
