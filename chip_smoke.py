#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each kernel against its plain PyTorch version at the shapes of the 1080p
serving path, serves a few 1920×1088 frames of the 512k-Gaussian scene
through `repro_torch.serving.hd1080_engine` (SPILL passes of 512 entries
through both kernels), and checks each frame against the all-"torch" plan
render of the same camera. Phases, in order:

  1. card name and power limit; kernel build time
  2. K1, the entry CAT (csrc/prtu_entry.cu), on one real spill pass: mask
     equal to the plain version under FULL_FP32, flip rate < 5e-4 under
     MIXED, and the fp8 overflow rule (|Δ| > 464 never hits)
  3. K2, the fused blend (csrc/blend_fused.cu), on the same pass: rgb and
     transmittance within 2e-4 of the plain version, counters equal (a
     mismatch is allowed only where the plain transmittance lies within
     1e-6 of T_EPS, and is printed); two chained passes equal to one call
     over their concatenation
  4. serve >= 3 requests: per-request wall time, spill passes, work
     counters and PSNR against the plain render; both kernels' launch
     counts grow by exactly the passes served; then the stage walls of
     one warm frame and the device's busy share under torch.profiler
  5. one {"kernels": [...]} line, the card line, and as the last line
     {"ok": true, "device": {...}}

Exits non-zero without printing a result when CUDA is unavailable or any
phase fails. `--json PATH` also writes every measurement to PATH.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import (FULL_FP32, MIXED, RasterConfig,  # noqa: E402
                              Renderer, TestConfig, psnr)
from repro_torch.core.cat import leader_corners  # noqa: E402
from repro_torch.core.precision import PrecisionScheme  # noqa: E402
from repro_torch.core.raster import T_EPS, entry_alpha  # noqa: E402
from repro_torch.kernels import build, ops, prtu, render  # noqa: E402
from repro_torch.serving import (RenderRequest, hd1080_cameras,  # noqa: E402
                                 hd1080_engine)

N_REQUESTS = 3
# Published peaks of one H100 SXM (data sheet, dense): HBM bandwidth and
# fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of one (entry, mini-tile) CAT test in csrc/prtu_entry.cu:
# 4 leader adds, 4 subtracts, 12 separable-term and 8 cross-term products,
# 8 adds, 4 slack products, 4 compares (conversions not counted).
K1_OPS_PER_TEST = 44
# fp32 operations of one (pixel, entry) blend step in csrc/blend_fused.cu,
# the expf counted as one.
K2_OPS_PER_EVAL = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 2: K1
# ---------------------------------------------------------------------------

def prec_kw(p: PrecisionScheme) -> dict:
    return dict(mode="smooth_focused", coord_prec=p.coord,
                delta_prec=p.delta, mul_prec=p.mul, acc_prec=p.acc,
                slack=p.slack)


def phase_k1(proj, grid, lists, valid) -> dict:
    operands = ops.entry_cat_operands(proj, grid, lists, valid)
    result = {}
    for name, p in (("fp32", FULL_FP32), ("mixed", MIXED)):
        got = prtu.prtu_entry_cat_mask(*operands, **prec_kw(p))
        want = prtu.prtu_entry_cat_mask_plain(*operands, **prec_kw(p))
        flips = int((got != want).sum())
        result[f"flips_{name}"] = flips
        result[f"hits_{name}"] = int(want.sum())
        log(f"[k1] {name}: {flips} flips of {want.numel()} mini-tile tests "
            f"({int(want.sum())} hits)")
    n = result["tests"] = lists.numel() * 16
    check(result["flips_fp32"] == 0, "K1 differs from its plain version "
          "under FULL_FP32")
    check(result["flips_mixed"] < 5e-4 * n, "K1 MIXED flip rate >= 5e-4")
    result["max_abs_err"] = float(min(result["flips_mixed"], 1))

    # The fp8 overflow rule (fault F1) on the card: Δ = 470.5 is NaN in
    # e4m3fn and never hits; 400.5 and 463.5 quantize to 416 and 448 and do.
    dev = lists.device
    top, bot = leader_corners(grid, dev)
    f1 = prtu.prtu_entry_cat_mask(
        top, bot, torch.zeros((1, 2), device=dev),
        torch.tensor([[[-400.0, 8.0], [-470.0, 8.0], [-463.0, 8.0]]],
                     device=dev),
        torch.tensor([[[1e-6, 0.0, 1e-6]] * 3], device=dev),
        torch.full((1, 3), 5.0, device=dev),
        torch.zeros((1, 3), dtype=torch.int8, device=dev),
        mode="uniform_dense", coord_prec="fp32", delta_prec="fp8",
        mul_prec="fp32", acc_prec="fp32", slack=0.0).cpu()
    log(f"[k1] fp8 overflow rule: hits at |Δ| 400.5/470.5/463.5 = "
        f"{f1[0, :, 0].tolist()}")
    check(f1[0, 0, 0] == 1 and f1[0, 2, 0] == 1 and not f1[0, 1].any(),
          "K1 fp8 conversion does not give NaN past 464")

    kw = prec_kw(MIXED)
    result["ms"] = time_ms(lambda: prtu.prtu_entry_cat_mask(*operands, **kw),
                           20)
    result["plain_ms"] = time_ms(
        lambda: prtu.prtu_entry_cat_mask_plain(*operands, **kw), 3)
    n_valid = int(valid.sum())
    result["bound_ms"], result["bound_by"] = bound_ms(
        nbytes(*operands) + lists.numel() * 16, n_valid * 16 * K1_OPS_PER_TEST)
    log(f"[k1] {result['ms']:.4f} ms/pass (plain {result['plain_ms']:.2f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{lists.numel()} entries, {n_valid} valid")
    return result


# ---------------------------------------------------------------------------
# Phase 3: K2
# ---------------------------------------------------------------------------

def near_tie_tiles(operands, tiles) -> torch.Tensor:
    """Min |T - T_EPS| over every pixel and entry the plain blend visits in
    `tiles` (the only place a kernel/plain counter mismatch may sit)."""
    pix, feat, _, valid, allow = (x[tiles] for x in operands)
    mt = render.pixel_minitile_index(pix.shape[1], allow.shape[2],
                                     pix.device)
    trans = torch.ones(pix.shape[:2], device=pix.device)
    closest = torch.full((len(tiles),), float("inf"), device=pix.device)
    for k in range(feat.shape[1]):
        closest = torch.minimum(closest,
                                (trans - T_EPS).abs().min(dim=1).values)
        lane = (valid[:, k, None] != 0) & (allow[:, k][:, mt] != 0)
        a = entry_alpha(pix, feat[:, k, 0:2], feat[:, k, 2:5], feat[:, k, 5],
                        lane)
        trans = trans * (1.0 - a)
    return closest


def compare_fused(got, want, operands, label: str) -> float:
    err = max(float((got.rgb - want.rgb).abs().max()),
              float((got.trans - want.trans).abs().max()))
    check(err <= 2e-4, f"K2 {label}: rgb/trans differ by {err}")
    bad = torch.zeros(got.trans.shape[0], dtype=torch.bool,
                      device=got.trans.device)
    for name in ("processed", "blended", "entry_alive"):
        d = (getattr(got, name) != getattr(want, name)).flatten(1).any(1)
        bad |= d
    bad |= got.kblocks_processed != want.kblocks_processed
    tiles = bad.nonzero().flatten()
    if len(tiles):
        closest = near_tie_tiles(operands, tiles)
        for t, c in zip(tiles.tolist(), closest.tolist()):
            log(f"[k2] {label}: counter mismatch in tile {t}, plain T "
                f"within {c:.3g} of T_EPS")
        check(bool((closest <= 1e-6).all()), f"K2 {label}: counters "
              "differ away from a T_EPS tie")
    log(f"[k2] {label}: max |Δ| rgb/trans {err:.3g}, {len(tiles)} tiles "
        "with a counter mismatch")
    return err


def phase_k2(proj, grid, houts) -> dict:
    p0, p1 = houts[0], houts[1]
    operands = ops.gather_tile_features(proj, grid, p0.lists, p0.valid,
                                        p0.entry_mini_mask)
    pix, feat, colors, valid, allow = operands
    kb = render.kblock_bound_of(valid)
    t, p = pix.shape[:2]
    init = (torch.ones((t, p), device=pix.device),
            torch.zeros((t, p, 3), device=pix.device),
            torch.zeros((t, p), device=pix.device),
            torch.zeros((t, p), device=pix.device))
    got = render.blend_tiles_fused(*operands, kblock_bound=kb, init=init)
    want = render.blend_tiles_fused_plain(*operands, kb, *init)
    result = {"max_abs_err": compare_fused(got, want, operands, "pass 0")}

    # Two chained 512-entry passes against one 1024-entry call.
    second = ops.gather_tile_features(proj, grid, p1.lists, p1.valid,
                                      p1.entry_mini_mask)
    chained = render.blend_tiles_fused(
        *second, init=(got.trans, got.rgb, got.processed, got.blended))
    cat_ops = (pix,) + tuple(torch.cat([a, b], dim=1).contiguous()
                             for a, b in zip(operands[1:], second[1:]))
    one = render.blend_tiles_fused(*cat_ops)
    for name in ("rgb", "trans", "processed", "blended"):
        check(torch.equal(getattr(chained, name), getattr(one, name)),
              f"K2 chained passes differ from one call in {name}")
    check(torch.equal(torch.cat([got.entry_alive, chained.entry_alive], 1),
                      one.entry_alive), "K2 chained entry_alive differs")
    check(torch.equal(got.kblocks_processed + chained.kblocks_processed,
                      one.kblocks_processed), "K2 chained kblocks differ")
    plain_one = render.blend_tiles_fused_plain(
        *cat_ops, render.kblock_bound_of(cat_ops[3]), *init)
    result["max_abs_err_chained"] = compare_fused(one, plain_one, cat_ops,
                                                  "1024-entry call")
    log("[k2] two chained passes == one 1024-entry call (bit-exact)")

    result["ms"] = time_ms(
        lambda: render.blend_tiles_fused(*operands, kblock_bound=kb,
                                         init=init), 20)
    result["plain_ms"] = time_ms(
        lambda: render.blend_tiles_fused_plain(*operands, kb, *init), 2)
    chunks = int(got.kblocks_processed.sum())
    in_bytes = nbytes(*operands, kb, *init)
    out_bytes = nbytes(got.rgb, got.trans, got.processed, got.blended,
                       got.kblocks_processed) + got.entry_alive.numel()
    result["bound_ms"], result["bound_by"] = bound_ms(
        in_bytes + out_bytes, chunks * render.K_BLK * p * K2_OPS_PER_EVAL)
    result["kblocks_processed"] = chunks
    result["kblocks_total"] = t * got.kblocks_total
    log(f"[k2] {result['ms']:.4f} ms/pass (plain {result['plain_ms']:.1f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{chunks} of {t * got.kblocks_total} K-blocks run")
    return result


# ---------------------------------------------------------------------------
# Phase 4: serve
# ---------------------------------------------------------------------------

def phase_serve(engine, name) -> dict:
    cams = hd1080_cameras(N_REQUESTS)
    requests = [RenderRequest(name, c, request_id=i)
                for i, c in enumerate(cams)]
    prtu.launches = render.launches = 0
    t0 = time.perf_counter()
    results = engine.render_batch(requests)
    wall = time.perf_counter() - t0
    launches = {"prtu_entry_cat_mask": prtu.launches,
                "blend_tiles_fused": render.launches}
    passes = sum(r.passes_run for r in results)
    rows = []
    for r, cam in zip(results, cams):
        c = {k: float(v) for k, v in r.counters.items()}
        check(r.image.shape == (cam.height, cam.width, 3), "frame shape")
        check(bool(torch.isfinite(r.image).all()), "non-finite pixels")
        check(not r.overflow, "a SPILL frame reported overflow")
        plan = engine.plan_for(name, cam.height, cam.width)
        plain = Renderer.from_plan(plan).replace(
            test=TestConfig(backend="torch"), raster=RasterConfig())
        ref, _ = plain.render_with_stats(engine.scene(name),
                                         cam.to(engine.device))
        q = float(psnr(r.image, ref.image))
        err = float((r.image - ref.image).abs().max())
        check(err <= 2e-4, f"request {r.request.request_id}: frame differs "
              f"from the plain render by {err} (PSNR {q:.2f} dB)")
        row = dict(request=r.request.request_id, wall_s=r.render_s,
                   passes_run=r.passes_run, spill_passes=c["spill_passes"],
                   processed_per_pixel=c["processed_per_pixel"],
                   kblocks_processed=c["kblocks_processed"],
                   kblocks_total=c["kblocks_total"], psnr_db=q,
                   max_abs_err=err, counters=c)
        rows.append(row)
        log(f"[serve] request {row['request']}: {r.render_s * 1e3:.1f} ms, "
            f"{int(c['spill_passes'])} of {r.passes_run} spill passes used, "
            f"processed/px {c['processed_per_pixel']:.2f}, K-blocks "
            f"{int(c['kblocks_processed'])}/{int(c['kblocks_total'])}, "
            f"PSNR vs plain {q:.2f} dB (max |Δ| {err:.2e})")
    log(f"[serve] {N_REQUESTS} requests in {wall:.3f} s; launches "
        f"{launches} for {passes} passes ({engine.spill_retries} spill "
        "retries)")
    for kname, n in launches.items():
        check(n == passes, f"{kname} launched {n} times for {passes} "
              "passes served")
        check(n > 0, f"{kname} never launched on the main path")
    return dict(requests=rows, wall_s=wall, launches=launches,
                passes=passes)


# ---------------------------------------------------------------------------
# Phase 4b: where a request's time goes
# ---------------------------------------------------------------------------

def phase_breakdown(engine, name) -> dict:
    """Stage walls of one warm frame (device-synchronized around each
    stage), and the device's busy share under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cam = hd1080_cameras(N_REQUESTS)[0].to(engine.device)
    plan = engine.plan_for(name, cam.height, cam.width)
    scene = engine.scene(name)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    plan.render_with_stats(scene, cam, enforce=False)           # warm-up
    ps, pre = timed(lambda: plan.preprocess(scene, cam))
    streams, s1 = timed(lambda: plan.stage1_compact(ps))
    houts, ctu = timed(lambda: [plan.ctu(ps, ts) for ts in streams])
    _, blend = timed(lambda: plan._blend_passes(ps, houts))
    _, total = timed(lambda: plan.render_with_stats(scene, cam,
                                                    enforce=False))
    stages = dict(preprocess=pre, stage1_compact=s1, ctu=ctu, blend=blend,
                  rest=total - pre - s1 - ctu - blend, total=total)
    log("[breakdown] ms per stage, " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items())
        + f" ({plan.n_passes} passes)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan.render_with_stats(scene, cam, enforce=False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # Device-side events only: the CPU-side aten rows carry their
    # kernels' time again.
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    ours = {k: v for k, v in rows if "prtu_entry" in k or "blend_fused" in k}
    log(f"[breakdown] profiled frame: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%), of it K1+K2 "
        f"{sum(ours.values()):.1f} ms; top device time: "
        + "; ".join(f"{k[:50]} {v:.1f} ms" for k, v in rows[:6]))
    return dict(stages_ms=stages, passes=plan.n_passes,
                profiled_wall_ms=wall, device_busy_ms=busy,
                kernel_device_ms=ours, top_device_ms=rows[:12])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", metavar="PATH",
                        help="also write every measurement to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {built} in {time.perf_counter() - t0:.2f} s")
    summary = {"card": card, "build_s": built,
               "torch": torch.__version__, "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    engine, name = hd1080_engine()
    entry = engine._scenes[name]
    plan = engine.plan_for(name, 1088, 1920)
    log(f"[setup] scene {entry.n_real} Gaussians, probed k_max "
        f"{entry.k_max} -> {plan.n_passes} passes of {plan.stream.k_max}, "
        f"{time.perf_counter() - t0:.2f} s")

    # One real frame's passes, for the kernel phases.
    cam = hd1080_cameras(N_REQUESTS)[0].to(engine.device)
    ps = plan.preprocess(entry.scene, cam)
    streams = plan.stage1_compact(ps)
    check(len(streams) >= 2, "the kernel phases need two spill passes")
    houts = [plan.ctu(ps, ts) for ts in streams[:2]]
    summary["k1"] = phase_k1(ps.proj, ps.grid, streams[0].lists,
                             streams[0].valid)
    summary["k2"] = phase_k2(ps.proj, ps.grid, houts)
    del houts, streams, ps
    summary["serve"] = phase_serve(engine, name)
    summary["breakdown"] = phase_breakdown(engine, name)

    kernels = []
    for kname, src, replaces, res in (
            ("prtu_entry_cat_mask", "src/repro_torch/kernels/csrc/"
             "prtu_entry.cu", "src/repro/kernels/prtu.py:222",
             summary["k1"]),
            ("blend_tiles_fused", "src/repro_torch/kernels/csrc/"
             "blend_fused.cu", "src/repro/kernels/render.py:298",
             summary["k2"])):
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=summary["serve"]["launches"][kname],
            max_abs_err=res["max_abs_err"], ms=res["ms"],
            plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None, phase="ok"))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
