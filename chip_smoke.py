#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each kernel against its plain PyTorch version at the shapes of its path,
serves a few 1920×1088 frames of the 512k-Gaussian scene through
`repro_torch.serving.hd1080_engine` (SPILL passes of 512 entries through
K1 and K2), checks each frame against the all-"torch" plan render of the
same camera, then renders one 1024×1024 frame of a 131072-Gaussian scene
through the dense-mask oracle (K4), the stream path and the AABB/OBB
baselines and holds the stream frame against the oracle bit for bit.
Phases, in order:

  1. card name and power limit; kernel build time
  2. K1, the entry CAT (csrc/prtu_entry.cu), on one real spill pass: mask
     equal to the plain version under FULL_FP32, flip rate < 5e-4 under
     MIXED, and the fp8 overflow rule (|Δ| > 464 never hits)
  3. K2, the fused blend (csrc/blend_fused.cu), on the same pass: rgb and
     transmittance within 2e-4 of the plain version, counters equal (a
     mismatch is allowed only where the plain transmittance lies within
     1e-6 of T_EPS, and is printed); two chained passes equal to one call
     over their concatenation
  3b. K3, the full-sweep blend (csrc/blend_full.cu), on the same pass:
     rgb/trans within 1e-6 of its plain version and within 2e-4 of K2
     (which stops only below T_EPS); ms/pass beside K2's. A blend's bound
     counts the pixel-entry lanes it needs (set mini-tile bits only)
  4. serve >= 3 requests: per-request wall time, spill passes, work
     counters and PSNR against the plain render; both kernels' launch
     counts grow by exactly the passes served; then the stage walls of
     one warm frame and the device's busy share under torch.profiler
  6. the 1024² / 131072-Gaussian frame (k_max probed, one pass):
     a. K4, the dense CAT (csrc/prtu_dense.cu): the full 65536 × 131072
        mask equal to its plain version under FULL_FP32 and MIXED, no hit
        where |Δ| > 464 under MIXED, ms per call against its bound;
     b. the frame through the stream path, the dense plan and
        `RenderEngine(dataflow="dense")` (counted): walls, CAT mask bytes,
        peak device memory (the dense frame under 24 GiB); then, stage by
        stage, lists, gated entry masks, images and every shared counter
        equal between the two dataflows;
     c. the AABB and OBB baselines: walls, work counters, PSNR against the
        CAT frame;
     d. the unfused baseline blend of the stream frame through K3
        (`ops.blend_tiles_cuda`, counted) within 2e-4 of the fused frame,
        then K3 within 1e-6 of its plain version on the same operands,
        with its ms and bound there (the kernels line reports this shape)
  5. one {"kernels": [...]} line, the card line, and as the last line
     {"ok": true, "device": {...}}

Exits non-zero without printing a result when CUDA is unavailable or any
phase fails. `--json PATH` also writes every measurement to PATH.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import (FULL_FP32, MIXED, GridConfig,  # noqa: E402
                              RasterConfig, RenderPlan, Renderer,
                              StreamConfig, TestConfig, default_camera,
                              measure_k_max, psnr, random_scene)
from repro_torch.core.cat import leader_corners  # noqa: E402
from repro_torch.core.hierarchy import count_true  # noqa: E402
from repro_torch.core.raster import entry_mask_from_dense, untile  # noqa: E402
from repro_torch.core.precision import PrecisionScheme  # noqa: E402
from repro_torch.core.raster import T_EPS, entry_alpha  # noqa: E402
from repro_torch.kernels import build, ops, prtu, render  # noqa: E402
from repro_torch.serving import (HD_SCENE_KW, RenderEngine,  # noqa: E402
                                 RenderRequest, hd1080_cameras,
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
# fp32 operations of one (pixel, entry) blend lane in csrc/blend_full.cu:
# 2 subtracts, 7 products and 2 adds of the exponent; its negation, the
# expf (counted as one), the opacity product, the clamp, the alpha_min
# compare and select; T*a, 3 colour products and 3 adds, 1 - a, T*(1 - a).
# A blend's bound counts only the lanes it needs: the pixels of each set
# mini-tile bit of each entry it must blend (`blend_lanes`).
K3_OPS_PER_LANE = 26
# csrc/blend_fused.cu adds the liveness compare and the processed/blended
# counters' compare and add each.
K2_OPS_PER_LANE = 30
# The dense-oracle point: the largest of the reference's scaling ladder
# (benchmarks/scaling.py), its scene distribution, one seed.
P1024_RES, P1024_GAUSSIANS, P1024_SEED = 1024, 1 << 17, 1024
DENSE_PEAK_LIMIT = 24 << 30          # bytes the dense frame may hold
PLAIN_COLUMNS = 1024                 # Gaussian columns per plain K4 block


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(name: str, fn, *args):
    """Run one phase and print its wall."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {name}: {time.perf_counter() - t0:.2f} s")
    return out


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


def blend_lanes(pix, allow, entries) -> int:
    """(pixel, entry) lanes a blend must evaluate: the pixels of every set
    mini-tile bit of each entry in `entries` ((T, K) bool)."""
    bits = (allow != 0).sum(dim=2, dtype=torch.int64)           # (T, K)
    return int((bits * entries).sum()) * (pix.shape[1] // allow.shape[2])


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
    # The lanes it needs: those of the entries some pixel of the tile
    # was still alive for.
    lanes = blend_lanes(pix, allow, got.entry_alive & (valid != 0))
    result["bound_ms"], result["bound_by"] = bound_ms(
        in_bytes + out_bytes, lanes * K2_OPS_PER_LANE)
    result["kblocks_processed"] = chunks
    result["kblocks_total"] = t * got.kblocks_total
    result["lanes"] = lanes
    log(f"[k2] {result['ms']:.4f} ms/pass (plain {result['plain_ms']:.1f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{chunks} of {t * got.kblocks_total} K-blocks run, {lanes} "
        "pixel-entry lanes needed")
    return result


# ---------------------------------------------------------------------------
# K3: against its plain version (hd1080 pass 0 here, the 1024² frame in
# phase 6d), and against K2
# ---------------------------------------------------------------------------

def k3_against_plain(operands, label: str) -> dict:
    """K3 within 1e-6 of its plain version on `operands`; its ms, plain
    ms and bound there."""
    pix, feat, _, valid, allow = operands
    got = render.blend_tiles(*operands)
    want = render.blend_tiles_plain(*operands)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= 1e-6, f"K3 ({label}) differs from its plain version by "
          f"{err}")
    result = {"max_abs_err": err}
    result["ms"] = time_ms(lambda: render.blend_tiles(*operands), 20)
    result["plain_ms"] = time_ms(lambda: render.blend_tiles_plain(*operands),
                                 1)
    t, k = valid.shape
    n_valid = int((valid != 0).sum())
    lanes = result["lanes"] = blend_lanes(pix, allow, valid != 0)
    result["bound_ms"], result["bound_by"] = bound_ms(
        nbytes(*operands, *got), lanes * K3_OPS_PER_LANE)
    log(f"[k3] {label}: max |Δ| rgb/trans vs plain {err:.3g}; "
        f"{result['ms']:.4f} ms/pass (plain {result['plain_ms']:.1f} ms), "
        f"bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{t * k} slots swept, {n_valid} valid, {lanes} pixel-entry lanes "
        "needed")
    return result


def phase_k3(proj, grid, hout, k2: dict) -> dict:
    """K3 on the hd1080 pass K1 and K2 were checked on: against its plain
    version, against K2 on the same operands, and its ms beside K2's."""
    operands = ops.gather_tile_features(proj, grid, hout.lists, hout.valid,
                                        hout.entry_mini_mask)
    result = k3_against_plain(operands, "hd1080 pass 0")
    got = render.blend_tiles(*operands)
    fused = render.blend_tiles_fused(*operands)
    err_k2 = max(float((got[0] - fused.rgb).abs().max()),
                 float((got[1] - fused.trans).abs().max()))
    check(err_k2 <= 2e-4, f"K3 differs from K2 by {err_k2}")
    result["max_abs_err_vs_k2"] = err_k2
    log(f"[k3] hd1080 pass 0: max |Δ| rgb/trans vs K2 {err_k2:.3g}; K3 "
        f"{result['ms']:.4f} ms/pass beside K2's {k2['ms']:.4f} ms")
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

def stage_walls(plan, scene, cam, label: str) -> dict:
    """Stage walls in ms of one warm frame of `plan`, device-synchronized
    around each stage."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    plan.render_with_stats(scene, cam, enforce=False)           # warm-up
    _, total = timed(lambda: plan.render_with_stats(scene, cam,
                                                    enforce=False))
    ps, pre = timed(lambda: plan.preprocess(scene, cam))
    streams, s1 = timed(lambda: plan.stage1_compact(ps))
    houts, ctu = timed(lambda: [plan.ctu(ps, ts) for ts in streams])
    _, blend = timed(lambda: plan._blend_passes(ps, houts))
    stages = dict(preprocess=pre, stage1_compact=s1, ctu=ctu, blend=blend,
                  rest=total - pre - s1 - ctu - blend, total=total)
    log(f"[{label}] ms per stage, " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items())
        + f" ({plan.n_passes} passes)")
    return stages


def phase_breakdown(engine, name) -> dict:
    """Stage walls of one warm frame, and the device's busy share under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cam = hd1080_cameras(N_REQUESTS)[0].to(engine.device)
    plan = engine.plan_for(name, cam.height, cam.width)
    scene = engine.scene(name)
    stages = stage_walls(plan, scene, cam, "breakdown")

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


# ---------------------------------------------------------------------------
# Phase 6: the 1024² dense-oracle point
# ---------------------------------------------------------------------------

def p1024_setup(dev=torch.device("cuda")) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(P1024_SEED)
    scene = random_scene(gen, P1024_GAUSSIANS, device=dev, **HD_SCENE_KW)
    cam = default_camera(P1024_RES, P1024_RES, device=dev)
    grid = GridConfig(P1024_RES, P1024_RES)
    k_max = measure_k_max(scene, [cam], grid=grid, cap=scene.n)
    plan = RenderPlan(grid=grid, test=TestConfig(backend="cuda"),
                      stream=StreamConfig(k_max=k_max),
                      raster=RasterConfig(fused=True))
    log(f"[1024] {scene.n} Gaussians at {P1024_RES}², probed k_max "
        f"{k_max} (one pass)")
    return dict(scene=scene, cam=cam, plan=plan, k_max=k_max)


def row_blocks(m: int, n: int):
    """Row slices of an (m, n) mask of about 2**26 elements each: a
    reduction of a whole 8.6e9-element mask would first copy it to int64."""
    rows = max(1, (1 << 26) // n)
    return [slice(s, s + rows) for s in range(0, m, rows)]


def plain_dense_mask(operands, kw) -> torch.Tensor:
    """K4's plain version over the full mask, PLAIN_COLUMNS Gaussian
    columns at a time (its (M, columns, 4) weights stay bounded)."""
    p_top, p_bot, mu, conic, lhs, spiky = operands
    out = torch.empty((p_top.shape[0], mu.shape[0]), dtype=torch.int8,
                      device=mu.device)
    for s in range(0, mu.shape[0], PLAIN_COLUMNS):
        cols = slice(s, s + PLAIN_COLUMNS)
        out[:, cols] = prtu.prtu_cat_mask_plain(
            p_top, p_bot, mu[cols], conic[cols], lhs[cols], spiky[cols],
            **kw)
    return out


def far_pairs(operands, kw, mask) -> tuple[int, int]:
    """(pairs, hits among them) of the pairs of an in-frustum Gaussian whose
    two leader x deltas, or two leader y deltas, exceed 464 px in magnitude
    after the coordinate quantization: every corner's fp8 delta is NaN
    there, so no corner may pass. Counted PLAIN_COLUMNS Gaussian columns at
    a time."""
    p_top, p_bot, mu, _, lhs, _ = operands
    q = {"fp16": lambda x: x.half().float(), "fp32": lambda x: x}[
        kw["coord_prec"]]
    pairs = hits = 0
    for s in range(0, mu.shape[0], PLAIN_COLUMNS):
        cols = slice(s, s + PLAIN_COLUMNS)
        far = torch.zeros((p_top.shape[0], mu[cols].shape[0]),
                          dtype=torch.bool, device=mu.device)
        for a in (0, 1):
            mu_a = q(mu[cols, a])[None, :]
            top = (q(p_top[:, a])[:, None] - mu_a).abs() > 464
            far |= top & ((q(p_bot[:, a])[:, None] - mu_a).abs() > 464)
        far &= torch.isfinite(lhs[cols])[None, :]
        pairs += int(far.sum())
        hits += int((far & (mask[:, cols] != 0)).sum())
    return pairs, hits


def phase_k4(pt: dict) -> dict:
    plan, scene, cam = pt["plan"], pt["scene"], pt["cam"]
    ps = plan.preprocess(scene, cam)
    operands = ops.cat_mask_operands(ps.proj, ps.grid)
    m, n = operands[0].shape[0], operands[2].shape[0]
    result = {"rows": m, "columns": n}
    for name, p in (("fp32", FULL_FP32), ("mixed", MIXED)):
        kw = prec_kw(p)
        got = prtu.prtu_cat_mask(*operands, **kw)
        want = plain_dense_mask(operands, kw)
        flips = sum(int((got[r] != want[r]).sum())
                    for r in row_blocks(m, n))
        result[f"flips_{name}"] = flips
        result[f"hits_{name}"] = int(count_true(got.view(torch.bool)))
        log(f"[k4] {name}: {flips} flips of {m * n} mini-tile tests "
            f"({result[f'hits_{name}']} hits)")
        check(flips == 0, f"K4 differs from its plain version ({name})")
        if name == "mixed":
            result["far_pairs"], far_hits = far_pairs(operands, kw, got)
            log(f"[k4] fp8 overflow rule: {far_hits} hits among "
                f"{result['far_pairs']} pairs with |Δ| > 464")
            check(result["far_pairs"] > 0 and far_hits == 0,
                  "K4 hits where every fp8 delta overflows")
        del got, want
    kw = prec_kw(MIXED)
    result["max_abs_err"] = float(result["flips_mixed"])
    result["ms"] = time_ms(lambda: prtu.prtu_cat_mask(*operands, **kw), 10)
    result["plain_ms"] = time_ms(lambda: plain_dense_mask(operands, kw), 1)
    n_live = int(torch.isfinite(operands[4]).sum())
    result["bound_ms"], result["bound_by"] = bound_ms(
        nbytes(*operands) + m * n, m * n_live * K1_OPS_PER_TEST)
    log(f"[k4] {result['ms']:.3f} ms/call (plain {result['plain_ms']:.1f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{m} mini-tiles x {n} Gaussians, {n_live} in frustum")
    return result


def render_frame(fn):
    """(result, wall s, peak bytes) of one device-synchronized render."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_dense_vs_stream(pt: dict) -> dict:
    plan, scene, cam = pt["plan"], pt["scene"], pt["cam"]
    dense = dataclasses.replace(plan, dataflow="dense")
    plan.render_with_stats(scene, cam)                         # warm-ups
    dense.render_with_stats(scene, cam)
    # The counted run: both dataflows through their entry points.
    prtu.launches = prtu.dense_launches = render.launches = 0
    (out_s, c_s), wall_s, peak_s = render_frame(
        lambda: plan.render_with_stats(scene, cam))
    (out_d, c_d), wall_d, peak_d = render_frame(
        lambda: dense.render_with_stats(scene, cam))
    engine = RenderEngine(plan, dataflow="dense")
    engine.register_scene("p1024", scene, k_max=pt["k_max"])
    served = engine.render_batch([RenderRequest("p1024", cam)])[0]
    launches = {"prtu_entry_cat_mask": prtu.launches,
                "prtu_cat_mask": prtu.dense_launches,
                "blend_tiles_fused": render.launches}
    log(f"[1024] launches {launches} (stream frame, dense frame, dense "
        "engine frame)")
    check(launches == {"prtu_entry_cat_mask": 1, "prtu_cat_mask": 2,
                       "blend_tiles_fused": 3}, "unexpected launch counts")
    mib = float(1 << 20)
    rows = {}
    for name, wall, peak, c in (("stream", wall_s, peak_s, c_s),
                                ("dense", wall_d, peak_d, c_d)):
        rows[name] = dict(wall_s=wall, peak_bytes=peak,
                          cat_mask_bytes=float(c["cat_mask_bytes"]))
        log(f"[1024] {name}: {wall * 1e3:.1f} ms, cat_mask_bytes "
            f"{float(c['cat_mask_bytes']) / mib:.1f} MiB, peak device memory "
            f"{peak / mib:.1f} MiB")
    rows["engine_dense_wall_s"] = served.render_s
    check(peak_d < DENSE_PEAK_LIMIT, f"dense frame peak {peak_d} bytes")
    check(torch.equal(out_s.image, out_d.image), "dense and stream images "
          "differ")
    check(torch.equal(served.image, out_d.image), "the engine's dense frame "
          "differs from the plan's")
    check(bool(torch.isfinite(out_s.image).all()), "non-finite pixels")
    shared = sorted((set(c_s) & set(c_d)) - {"cat_mask_bytes"})
    differ = [k for k in shared if float(c_s[k]) != float(c_d[k])]
    check(not differ, f"counters differ between dataflows: {differ}")
    log(f"[1024] images equal; {len(shared)} shared counters equal")

    # Stage by stage: lists and gated per-entry masks.
    ps = plan.preprocess(scene, cam)
    ts_s, = plan.stage1_compact(ps)
    h_s = plan.ctu(ps, ts_s)
    ts_d, = dense.stage1_compact(ps)
    check(torch.equal(ts_s.lists, ts_d.lists)
          and torch.equal(ts_s.valid, ts_d.valid), "tile lists differ")
    gathered = entry_mask_from_dense(ps.grid, ts_d.dense.minitile_mask,
                                     ts_d.lists) & ts_d.valid[:, :, None]
    check(torch.equal(gathered, h_s.entry_mini_mask),
          "dense entry masks differ from the stream CTU's")
    log(f"[1024] lists equal ({int(ts_s.valid.sum())} entries), gated "
        "entry masks equal")
    del ts_d, gathered
    for name, p in (("stream", plan), ("dense", dense)):
        rows[name]["stages_ms"] = stage_walls(p, scene, cam, f"1024 {name}")
    return dict(rows=rows, launches=launches, counters={
        k: float(c_s[k]) for k in shared}, stream_out=out_s,
        stream_hout=h_s, ps=ps)


def phase_baselines(pt: dict, cat_image) -> dict:
    plan, scene, cam = pt["plan"], pt["scene"], pt["cam"]
    rows = {}
    for method in ("aabb", "obb"):
        base = dataclasses.replace(plan, test=TestConfig(
            method=method, precision=FULL_FP32, backend="cuda"))
        (out, c), wall, peak = render_frame(
            lambda: base.render_with_stats(scene, cam))
        check(bool(torch.isfinite(out.image).all()), f"{method}: pixels")
        q = float(psnr(out.image, cat_image))
        rows[method] = dict(wall_s=wall, peak_bytes=peak, psnr_vs_cat_db=q,
                            **{k: float(v) for k, v in c.items()})
        dup = "dup_tile" if method == "aabb" else "dup_subtile"
        log(f"[1024] {method}: {wall * 1e3:.1f} ms, vru_pairs "
            f"{float(c['vru_pairs']):.0f}, {dup} {float(c[dup]):.0f}, PSNR "
            f"vs CAT {q:.2f} dB, peak {peak / float(1 << 20):.1f} MiB")
    return rows


def phase_unfused(dvs: dict) -> dict:
    """The unfused baseline blend of the stream frame through K3 (counted),
    within 2e-4 of the fused frame; then K3 against its plain version on
    the same operands, with its ms and bound at this shape."""
    ps, h, out = dvs["ps"], dvs["stream_hout"], dvs["stream_out"]
    render.full_launches = 0
    (rgb, _), wall, _ = render_frame(lambda: ops.blend_tiles_cuda(
        ps.proj, ps.grid, h.lists, h.valid, h.entry_mini_mask))
    launches = render.full_launches
    err = float((untile(ps.grid, rgb) - out.image).abs().max())
    log(f"[1024] unfused K3 blend: {wall * 1e3:.1f} ms, {launches} launch, "
        f"max |Δ| vs the fused frame {err:.3g}")
    check(launches == 1, "K3 was not launched on the unfused path")
    check(err <= 2e-4, f"unfused frame differs from the fused one by {err}")
    operands = ops.gather_tile_features(ps.proj, ps.grid, h.lists, h.valid,
                                        h.entry_mini_mask)
    return dict(k3_against_plain(operands, "1024 frame"), wall_s=wall,
                launches=launches, max_abs_err_vs_fused=err)


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
    summary["k3_hd1080"] = timed_phase("k3", phase_k3, ps.proj, ps.grid,
                                       houts[0], summary["k2"])
    del houts, streams, ps
    summary["serve"] = phase_serve(engine, name)
    summary["breakdown"] = phase_breakdown(engine, name)
    del engine

    pt = timed_phase("1024 setup", p1024_setup)
    summary["k4"] = timed_phase("k4", phase_k4, pt)
    dvs = timed_phase("dense vs stream", phase_dense_vs_stream, pt)
    summary["dense_vs_stream"] = {k: dvs[k] for k in
                                  ("rows", "launches", "counters")}
    summary["baselines"] = timed_phase("baselines", phase_baselines, pt,
                                       dvs["stream_out"].image)
    summary["unfused"] = timed_phase("unfused blend", phase_unfused, dvs)
    launches = dict(summary["serve"]["launches"],
                    prtu_cat_mask=dvs["launches"]["prtu_cat_mask"],
                    blend_tiles=summary["unfused"]["launches"])

    kernels = []
    csrc = "src/repro_torch/kernels/csrc/"
    for kname, src, replaces, res in (
            ("prtu_entry_cat_mask", csrc + "prtu_entry.cu",
             "src/repro/kernels/prtu.py:222", summary["k1"]),
            ("blend_tiles_fused", csrc + "blend_fused.cu",
             "src/repro/kernels/render.py:298", summary["k2"]),
            ("blend_tiles", csrc + "blend_full.cu",
             "src/repro/kernels/render.py:149", summary["unfused"]),
            ("prtu_cat_mask", csrc + "prtu_dense.cu",
             "src/repro/kernels/prtu.py:128", summary["k4"])):
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=replaces,
            launches=launches[kname],
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
