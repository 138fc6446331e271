"""Serving driver.

--mode render : the paper's workload at request level — a mixed multi-scene
                stream (2 scenes, 2 resolutions, varying batch sizes)
                micro-batched through `repro_torch.serving.RenderEngine`
                on a one-device mesh; buckets keep the plan cache small,
                telemetry reports latency percentiles and the modeled
                FLICKER accelerator FPS. `--pallas` runs the CTU on its
                CUDA kernel (the "cuda" test backend, K1); the blend is
                the plain unfused one either way.
--mode lm     : prefill + greedy decode for any registry --arch (dense,
                MoE, SSM, hybrid, enc-dec; `--reduced` for a CPU-sized
                config), from random weights drawn from a seeded
                generator. As in the reference, decode
                starts from fresh caches sized prefill + decode, so the
                decoded tokens do not attend to the prompt: the loop times
                decode steps, it does not continue the prompt.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode render --frames 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch qwen1.5-0.5b --reduced --prefill 64 --decode 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
        --arch deepseek-v2-lite-16b --param-dtype bfloat16

Everything runs on `--device` (default "cuda"); with "cuda" and no CUDA
device the driver exits non-zero without running. `run_render` and
`run_lm` return what was served (frames, tokens, walls) for callers that
check it; `main` prints it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.launch.mesh import make_local_mesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_engine(args):
    """The driver's engine with the demo scenes registered (probe-driven
    k_max over both served resolutions)."""
    from repro_torch.core import (MIXED, Renderer, SamplingMode, TestConfig,
                                  orbit_camera)
    from repro_torch.serving import RenderEngine, register_demo_scenes

    dev = torch.device(args.device)
    renderer = Renderer(test=TestConfig(
        method="cat", mode=SamplingMode.SMOOTH_FOCUSED, precision=MIXED,
        backend="cuda" if args.pallas else "torch"))
    engine = RenderEngine(renderer, device=dev, mesh=make_local_mesh(dev),
                          max_batch=args.max_batch)
    # The engine's OverflowPolicy.WARN flags any off-probe pose that still
    # overflows, and telemetry counts it in overflow_frames.
    probes = [orbit_camera(t, r, r)
              for r in resolutions(args)
              for t in (0.0, 1.6, 3.2, 4.8)]
    register_demo_scenes(engine, args.gaussians, probe_cameras=probes)
    return engine


def resolutions(args) -> tuple:
    return (args.res, max(args.res // 2, 16))


def render_requests(args, scenes) -> list:
    """The driver's workload as waves: one list of (scene, camera) a wave.

    Requests cluster on hot scenes: the scene flips every 4 requests and
    the resolution every 4 * len(scenes), so every scene x resolution
    pair occurs over a long run while consecutive requests still form
    multi-frame batches. Wave sizes vary so several batch buckets are
    exercised."""
    from repro_torch.core import orbit_camera

    res_of = resolutions(args)
    wave_sizes = [1, 2, 4, args.max_batch]
    waves, submitted, w = [], 0, 0
    while submitted < args.frames:
        wave = min(wave_sizes[w % len(wave_sizes)], args.frames - submitted)
        reqs = []
        for j in range(submitted, submitted + wave):
            res = res_of[(j // (4 * len(scenes))) % len(res_of)]
            reqs.append((scenes[(j // 4) % len(scenes)],
                         orbit_camera(2 * np.pi * j / args.frames, res, res)))
        waves.append(reqs)
        submitted += wave
        w += 1
    return waves


def run_render(args, log=print) -> dict:
    """Serve the render workload; returns dict(engine, results (one
    `RequestResult` per request, in submission order), waves (requests
    and wall in ms of each wave))."""
    from repro_torch.serving import MicroBatcher

    engine = render_engine(args)
    batcher = MicroBatcher(engine)
    futures, waves = [], []
    for w, reqs in enumerate(render_requests(args, engine.scene_names())):
        futures += [batcher.submit(scene, cam) for scene, cam in reqs]
        t0 = time.perf_counter()
        served = batcher.flush()
        _sync(engine.device)
        ms = (time.perf_counter() - t0) * 1e3
        waves.append(dict(requests=served, ms=ms))
        log(f"wave {w + 1}: {served} requests in {ms:7.1f} ms "
            f"({engine.compile_count} plans built so far)")
    # All resolved by flush; result() raises on a failed request.
    results = [f.result(timeout=0) for f in futures]
    return dict(engine=engine, results=results, waves=waves)


def serve_render(args) -> int:
    out = run_render(args)
    engine = out["engine"]
    print(engine.telemetry.format_snapshot())
    print(f"plan cache: {engine.compile_count} plans for "
          f"{len(engine.scene_names())} scenes x {len(resolutions(args))} "
          f"resolutions x waves {[1, 2, 4, args.max_batch]}")
    return 0


def lm_model(args, mesh=None):
    """The driver's model: `--arch` (reduced under `--reduced`, its
    parameters held in `--param-dtype` where given) with weights drawn
    from seed 0 on `--device`, placed on `mesh` (default the one-device
    mesh of `--device`)."""
    from repro_torch.configs import get_arch, reduced as reduce_cfg
    from repro_torch.models.model import Model

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    dev = torch.device(args.device)
    return Model(cfg, device=dev, seed=0,
                 mesh=mesh or make_local_mesh(dev))


def lm_batch(cfg, b: int, s: int, device) -> dict:
    """The driver's prompt, as the reference's: token id 1 everywhere, or
    zero embeddings for an embeddings-input (vlm/audio) config; an enc-dec
    config gets zero encoder embeddings of S frames and decoder tokens of
    1 (tested first: seamless also sets `embeds_input`)."""
    if cfg.family == "encdec":
        return dict(enc_embeds=torch.zeros((b, s, cfg.d_model),
                                           dtype=torch.bfloat16,
                                           device=device),
                    tokens=torch.ones((b, s), dtype=torch.int64,
                                      device=device))
    if cfg.embeds_input:
        return dict(embeds=torch.zeros((b, s, cfg.d_model),
                                       dtype=torch.bfloat16, device=device))
    return dict(tokens=torch.ones((b, s), dtype=torch.int64, device=device))


def run_lm(args, model=None, log=print) -> dict:
    """Prefill, then greedy decode from fresh caches. Returns dict(model,
    prefill_logits (B, V), tokens (B, decode) of the decoded ids, step
    logits (decode, B, V), prefill_ms, step_ms (one per decode step),
    each device-synchronized)."""
    model = model if model is not None else lm_model(args)
    cfg, dev = model.cfg, model.device
    b, s = args.batch, args.prefill
    batch = lm_batch(cfg, b, s, dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, _ = model.prefill(batch)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    log(f"prefill ({b}x{s}): {prefill_ms:.1f} ms logits "
        f"{tuple(logits.shape)}")

    # Decode with freshly initialized caches sized prefill+decode.
    caches = model.init_caches(b, s + args.decode)
    tok = torch.argmax(logits, -1)[:, None]
    step_ms, toks, step_logits = [], [], []
    for _ in range(args.decode):
        t0 = time.perf_counter()
        logits_i, caches = model.decode_step(caches, tok)
        tok = torch.argmax(logits_i, -1)[:, None]
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
        step_logits.append(logits_i)
    lat = np.array(step_ms[1:] if len(step_ms) > 1 else step_ms)
    tokens = torch.cat(toks, 1) if toks else torch.zeros((b, 0))
    if len(lat):
        log(f"decoded {args.decode} tokens; median {np.median(lat):.1f}"
            f" ms/token; last tokens {tokens[:4, -1].tolist()}")
    return dict(model=model, prefill_logits=logits, tokens=tokens,
                step_logits=step_logits, prefill_ms=prefill_ms,
                step_ms=step_ms)


def serve_lm(args) -> int:
    try:
        model = lm_model(args)
    except NotImplementedError as e:        # a mesh larger than one device
        print(f"serve: the LM is served on a one-device mesh only: {e}",
              file=sys.stderr)
        return 2
    run_lm(args, model)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="render", choices=["render", "lm"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    # render
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--gaussians", type=int, default=4000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--pallas", action="store_true",
                    help="run the CTU on its CUDA kernel (K1)")
    # lm
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prefill", type=int, default=64)
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--param-dtype", choices=["float32", "bfloat16"],
                    help="hold the parameters in this dtype (default: the "
                    "config's). bfloat16 keeps no float32 master copy: "
                    "deepseek-v2-lite-16b needs it to fit one 80 GB card")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        # No fallback to the CPU.
        print(f"serve: --device {args.device} was asked for but "
              "torch.cuda.is_available() is False; pass --device cpu to "
              "serve on the CPU", file=sys.stderr)
        return 2
    return serve_render(args) if args.mode == "render" else serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
