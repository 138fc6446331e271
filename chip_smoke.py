#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--passes-only | --offpath-only |
                          --sessions-only | --lod-only | --shards-only |
                          --train-only | --serve-only | --families-only |
                          --lm-train-only | --lm-mesh-only]

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/`, holds
each kernel against its plain PyTorch version at the shapes of its path,
serves a few 1920×1088 frames of the 512k-Gaussian scene through
`repro_torch.serving.hd1080_engine` (SPILL passes of 512 entries through
K1 and K2), checks each frame against the all-"torch" plan render of the
same camera, then renders one 1024×1024 frame of a 131072-Gaussian scene
through the dense-mask oracle (K4), the stream path and the AABB/OBB
baselines and holds the stream frame against the oracle bit for bit.
Phases, in order:

  1. card name and power limit; kernel build time and each kernel's
     registers, shared memory and spills (`-Xptxas -v`)
  1b. the kernels' rounding steps (csrc/alg1.cuh through the
     `prtu.alg1_quant` hook) over all 2**32 float32 bit patterns, in chunks
     of 2**28, one-value and paired, fp8 and fp16: bit-equal to the plain
     quantizer of core/precision.py (or both NaN), 0 mismatches
  2. K1, the entry CAT (csrc/prtu_entry.cu), on one real spill pass: mask
     equal to the plain version under FULL_FP32 and MIXED, and the fp8
     overflow rule (|Δ| > 464 never hits)
  3. K2, the fused blend (csrc/blend_fused.cu), on the same pass: rgb and
     transmittance within 2e-4 of the plain version, counters equal (a
     mismatch is allowed only where the plain transmittance lies within
     1e-6 of T_EPS, and is printed); two chained passes equal to one call
     over their concatenation
  3b. K3, the full-sweep blend (csrc/blend_full.cu), on the same pass:
     rgb/trans within 1e-6 of its plain version and within 2e-4 of K2
     (which stops only below T_EPS); device ms/pass beside K2's, the lane
     slots its walk issues against the lanes the data needs. A blend's
     bound counts the pixel-entry lanes it needs (set mini-tile bits only)
  4. serve 3 requests in the engine's batches (max_batch 2 at 1920×1088:
     a batch of 2 and a batch of 1): per-request wall time, spill passes,
     work counters and PSNR against the plain render; both kernels'
     launch counts grow by exactly one a pass of each dispatch; then the
     stage walls of one warm frame and the device's busy share under
     torch.profiler
  4c. every pass of request 0's frame on the plan the engine settled on:
     K1 equal to its plain version under FULL_FP32 and MIXED, K2 against
     its plain version from the carried state, each kernel's device ms
     (CUDA graph replays: short kernels are host-bound under back-to-back
     wrapper calls) against its bound, the per-frame sums, and K1 on an
     all-empty pass
  4d. requests 0 and 1 as one `render_batch` and each alone: K1 and K2
     launched once per pass of the batch, each batched frame bit-equal
     (image, alpha, every counter) to the request served alone and within
     2e-4 of the plain render; the batch's wall against the single walls
     and its device-busy ms against two single frames (torch.profiler);
     then K1 and K2 on the two frames' pass 0 folded into 2 × 8160 tiles
     against their plain versions, device ms against their bounds
  4e. one request under an enabled `obs.Tracer`: the dispatch spans and
     the reference's eager stage tree (render > preprocess,
     stage1_compact, ctu x n, blend x n, finalize), the ctu and blend
     deltas summing to the frame's counters; the JSONL and Chrome trace
     written under build/trace/; each stage span's wall
  4f. `open_loop_trace(16, seed=0)` at 1920×1088 through a `Scheduler`
     with a 544×960 fallback, replayed at 2x the single-request service
     rate with interactive deadlines of 1.5 single walls: every arrival
     served or rejected (`AdmissionRejected`), every degraded frame
     bit-equal to the direct 544×960 render of its pose, the futures'
     served/degraded/rejected/deadline-miss counts equal to the
     telemetry's; p50/p95/p99, frames/s and the perf model's FPS (a model
     of the FLICKER ASIC, not of the card)
  6. the 1024² / 131072-Gaussian frame (k_max probed, one pass):
     a. K4, the dense CAT (csrc/prtu_dense.cu): the full 65536 × 131072
        mask equal to its plain version under FULL_FP32 and MIXED, no hit
        where |Δ| > 464 under MIXED; under each, ms per call against its
        bound and the pairs it evaluates against those that can hit;
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
        with its device ms and bound there (the kernels line reports this
        shape)
  4g. runs last, after phase 6: frame-coherent sessions. An
     `incremental=True` engine on the hd1080 base plan with the 512k scene
     serves three sessions of four 1920×1088 frames each through
     `render_batch`, one session after the other: `static` (one pose,
     repeated), `drift` (`trajectory_cameras` at 2π/262144 a frame) and
     `orbit` (its default 2π/64). Each frame: tiles reused and
     recompacted, full recompactions, camera delta, the Stage-1 span wall
     (`stage1_incremental` or `stage1_compact`), the probe's wall and the
     frame's; K1 and K2 launched once a pass; image, alpha and every
     counter but the three coherence ones bit-equal to
     `render_with_stats` of the same pose on the same plan. `static`
     frames 1-3 reuse every tile, `orbit` frames all fall back
  7. runs after 4g: camera-dependent LOD at the reference's full LOD rung
     (benchmarks/scaling.py:396-415): 4,194,304 Gaussians drawn from
     torch.Generator("cuda").manual_seed(1 << 22), a 512² serve camera at
     fov 32°, three 128² probes, LODConfig(num_clusters=4096, ...). The
     scene goes through `save_ply` -> `load_ply` under build/lod/ first
     (means, scales, quats, opacity bit-equal, colors within 1e-6), and
     the loaded scene is used below.
     a. k-means and probe scoring timed apart, then `build_lod` twice
        from one generator seed: the two builds bit-equal;
     b. the served LOD frame against the full frame, each on the hd1080
        plan at 512² with the pass count of its measured bound
        (`measure_lod_k_max`, `measure_k_max`): clusters and Gaussians
        selected, ratio < 1, bucket, k_max and passes, the `stage0_lod`
        span wall, warm frame walls, stage walls and device-busy ms of
        both, PSNR >= 30 dB and SSIM, peak memory, K1 and K2 once a pass;
     c. select-all (no footprint or mass test): every tile whose lists
        hold the same Gaussians in the same order renders bit-equal to the
        full frame; the tiles whose lists differ by a depth tie the
        build's reorder swapped are counted and printed;
     d. a fresh engine on the hd1080 plan at 512² (max_batch 2):
        `register_scene(lod=...)` over three 512² poses, one batch of two
        requests (K1 and K2 once a pass of the batch), the lod_* counters
        and gauges, each frame >= 30 dB against its full render, and the
        same batch again a plan-cache hit, bit-identical
  8. runs after 7: multi-device rendering on the hd1080 configuration,
     every shard on this one card (a mesh of repeated devices): the
     schedule of a multi-card mesh, not a multi-card speedup.
     a. an engine with shard_tiles=4 over a virtual mesh of 4 serves
        requests 1 and 0 beside the unsharded engine (request 1 first
        settles both on the same pass bucket): each frame bit-equal
        (image, alpha, every counter the unsharded frame has), K1 and K2
        launched 4 times a pass of request 0's dispatch, the plan-level
        frames equal on every RenderOut field (entry_alive and the work
        maps too); tile_shards, shard_entries_max/min and their ratio;
        warm walls, device-busy ms and the top kernels by device time,
        sharded against unsharded
     b. K1 and K2 on shard 2's rows of pass 0 (2040 tiles, origins from
        mid-grid) against their plain versions (K1 0 flips, K2 as in
        phase 3), device ms from CUDA graph replays against the bound,
        the plain versions' ms
     c. `render_with_shard_recovery` with shards (1, 3) dropped: 4080
        tiles re-rendered under the parity gate, the frame equal to the
        engine's; recovery wall against the healthy frame's; the next
        frame healthy (shard_drops 0)
     d. a 2 frame x 2 tile virtual mesh serves requests 0-2 as one batch
        (bucket 4, split 2 + 2): each frame bit-equal to the unsharded
        engine's and within 2e-4 of the all-"torch" plan's render,
        tile_shards 2, K1 and K2 launched 2 x 2 times a pass
  9. runs after 8: scene training on the card, autograd through the
     all-"torch" plan (the kernels have no backward: train unfused, serve
     fused); 9a-9c launch no kernel.
     a. benchmarks/train_dataflow.py's 64² / 500-Gaussian scene:
        grad(stream) against grad(dense) under FULL_FP32, max relative
        error < 1e-3; a SPILL plan of 32 passes of 8 (MIXED) against its
        one pass of 256 within rtol 1e-5, atol 1e-7; forward and backward
        device ms of each plan under torch.profiler
     b. table1_quality.py's fit shape (64², 700 Gaussians, aabb,
        FULL_FP32, 40 of its 150 steps) against the sinusoid: the loss
        falls; PSNR before and after, ms a warm step, one step's
        device-busy share
     c. test_stream.py's 512² / 65,536-Gaussian scene (MIXED CAT, k_max
        1536; SPILL if a tile list overflows, and the count) fitted 5
        steps to the render of a second seeded scene: per step wall, loss
        and finite gradient share; the loss falls; peak memory against the
        tape's reckoning; one forward and backward under torch.profiler
        (device-busy ms, top 5 kernels)
     d. 9c's trained scene through K1 ("cuda" CTU) and K2 (fused): within
        2e-4 of the all-"torch" frame, K1 and K2 once a pass
     e. `fit` under a FaultManager (save_every 3, build/train_ckpt) for 6
        steps of 9a's fit, and a run resumed from the step-3 checkpoint,
        under deterministic algorithms: bit-equal; the checkpoints removed
  10. runs after 9: the serving driver, `repro_torch.launch.serve`, on
     the card.
     a. render mode through `serve.run_render`: `--frames 8 --res 1024
        --gaussians 131072 --max-batch 4 --pallas` (p1024's width and
        scene size, `register_demo_scenes`' two scenes probed at 1024²
        and 512²; the CTU on K1, the plain unfused blend): each wave's
        wall and the telemetry snapshot; K1 launched once a row range of
        each pass of each dispatch and K2 never; every served frame within
        2e-4 of the all-"torch" plan's render of its scene and camera. The
        scenes probe to k_max 8192, so a batch of 4 folds 16384 x 8192
        entries x 16 mini-tiles, K1's int32 index bound: its wrapper
        launches the fold in two row ranges (`prtu.entry_row_ranges`),
        and on such a fold K1 is held to its plain version on the 256
        tile rows either side of the split. A fold that trips a bound
        fails the phase
     b. LM mode at full width: `--arch qwen1.5-0.5b --batch 4 --prefill
        512 --decode 64` from seed-0 weights: prefill ms (the driver's
        first call, and warm), decode ms/token (median and p90 after the
        first step), tokens/s, the parameters' bytes against
        `param_count()`, `max_memory_allocated`, one warm decode step's
        device-busy ms under torch.profiler against its wall; every
        logit finite
     c. serving self-consistency at full width, the reference's gates:
        64 teacher-forced decode steps (batch 1) against `forward`'s
        logits, and the int8 KV cache (kv_quant) against the bf16 cache
        over the same tokens: relative RMS <= 0.05 and argmax agreement
        >= 0.9 each; the int8 cache's bytes <= 0.55 of the bf16 cache's.
        Measured first on the driver's seed-0 weights, then gated on the
        same weights with the attention projections rescaled to the
        contraction dimension's fan-in (`fan_in_attention`): under the
        reference's init the attention logits have a std of ~60 and a
        rounding difference grows several-fold a layer, so at 24 layers
        decode and forward part however each is computed
     d. card against CPU: the same weights of reduced qwen1.5-0.5b under
        float32 compute run forward, prefill and 8 teacher-forced decode
        steps on the card and on the CPU (`models.parity.lm_parity`):
        logits within rtol 1e-4 and atol 1e-4 x max|logit|, the decode
        under float32 caches; under the model's bf16 caches each cache
        element within one bf16 ulp (past float32 noise) and the logits
        reported: a last-place float32 difference rounds a K/V value to
        the other side of a bf16 boundary now and then
  11. runs after 10: LM serving for the MoE/MLA, SSM, hybrid and enc-dec
     families at full width and depth, from seed-0 weights through
     `serve.run_lm` at batch 4, prefill 512, decode 64 (the enc-dec with
     the reference driver's prompt: zero encoder frames, tokens of 1):
     11a deepseek-v2-lite-16b (the driver's `--param-dtype bfloat16`,
     the reference's own `param_dtype` field: float32 masters and a bf16
     copy would need 94 GB), 11b mamba2-780m, 11c zamba2-1.2b, 11d
     seamless-m4t-large-v2, each built by the driver (`serve.lm_model`);
     each as 10b (prefill ms first and warm, decode ms a token, tokens/s,
     peak memory, a warm step's device-busy ms and top kernels) and the
     step's byte bound (every weight a decode step reads, all 64 experts'
     for the MoE and not the enc-dec's encoder, and the caches' live part
     at 3.35 TB/s); each model freed before the next.
     e. per arch, 64 teacher-forced decode steps at batch 1 against
        `forward` (the SSM and hybrid forward at ssm_chunk 64, the MoE at
        moe_group 1 after its seed-0 run: its reference dispatch mixes the
        tokens of a group): logits at full depth measured on seed-0
        weights and with the attention projections at their contraction
        fan-in (`fan_in_attention`: self-, cross-, MLA and the hybrid's
        shared block), the enc-dec's gated there (relative RMS <= 0.05,
        agreement >= 0.9); the MoE's share of (token, layer) routed
        differently. The MoE, SSM and hybrid part past those gates with
        depth, in the reference as in the port (`python
        tests/test_torch_lm_families.py --depth-sweep`), so their logits
        are gated at full width on a model cut to FAMILY_GATE_DEPTH
        layers; then every arch gated layer by layer at full depth
        (`LayerTape`: each decode layer on the forward's input to it
        within relative RMS 0.03) (`family_self`)
     f. reduced arctic-480b, deepseek, mamba2, zamba2 and seamless under
        float32 compute: forward, prefill and 8 decode steps on the card
        against the CPU from the same weights, rtol 1e-4 and atol 1e-4 x
        max|logit| (a decode that reads back bf16 state, SSM, hybrid and
        enc-dec: max |d| <= 3e-3 x max|logit|, relative RMS <= 1.5e-3)
  12. runs after 11: LM training (launches none of the four kernels):
     a. qwen1.5-0.5b at full width and depth through the training driver
        (`launch.train.run`, `--batch 8 --seq 1024 --steps 12
        --save-every 6`, checkpoints under build/lm_ckpt, removed after):
        the warm steps' median wall, tokens/s, peak memory, one warm
        step's device-busy share and top kernels, and its model-FLOP
        share (6 N tokens + 12 L H hd S tokens of attention against 989
        TFLOP/s bf16 dense); loss and grad norm finite at every step and
        every parameter changed
     b. mamba2-780m at full width and depth (ssm_chunk 256) at batch 4 x
        512: the gradient with the reference's intra-chunk weight has
        non-finite leaves and the port's has none (F9); then 3 steps of
        `launch.steps.make_train_step`, the grad norm finite at every
        step; step walls and peak memory
     c. reduced qwen, deepseek, arctic, mamba2, zamba2 and seamless under
        float32 compute: one train step at the full rate on the card
        against the CPU from the same weights and batch: loss and grad
        norm rtol 1e-4; each float32 parameter's update within 1e-3 lr
        (plus two ulps of the parameter) where its gradient exceeds 1e-2
        of its leaf's largest; arctic's bf16 parameters move where the
        CPU's do and land within one bf16 ulp; every optimizer-state
        leaf within 1e-4 of its leaf's max |value| (arctic's moments from
        bf16 gradients within 2.5e-2)
     d. reduced qwen through the driver under deterministic algorithms:
        a 6-step run saving every 2 and preempted after step 4, restarted
        to 6, bit-equal to 6 uninterrupted steps (parameters and optimizer
        state)
  13. runs after 12: the dense LM over a mesh of virtual shards of the
     card (`distributed.sharding.Mesh` of repeated cuda:0; launches none
     of the four kernels):
     a. qwen1.5-0.5b at full width, float32 compute, over (data=2,
        model=2). On seed-0 weights the forward's logits on the mesh
        against one device, beside one device against itself with the
        batch in two halves (reported: under the reference's init a
        last-place difference grows several-fold a layer, as in 10c).
        Gated on the same weights after `fan_in_attention`: 3 steps of
        the training driver's step (AdamW on the whole batch, its lr
        schedule) at batch 4 x 1024 on the mesh and on one device from
        the same weights and batches: loss and grad
        norm within 1e-5 relative, every update within 1e-3 lr plus two
        float32 ulps where the one-device gradient exceeds 1e-2 of its
        leaf's largest, every replica bit-equal; then bf16 compute at
        12a's shape (batch 8 x 1024), 3 steps on each: step walls,
        one more step's device-busy share, peaks
     b. float32, `fan_in_attention` weights, batch 4: prefill 64
        tokens, then 16 greedy steps from
        fresh float32 caches of 16 (so that both model positions' blocks
        of the sequence are written) on the mesh and on one device: logits
        within rtol 1e-4 and atol 1e-4 x max|logit|, tokens equal, ms a
        token; then the int8 cache (`kv_quant`), the mesh fed the
        one-device run's greedy tokens: the int8 cache values within one
        step; the scales, logits and argmax agreement reported
     c. reduced qwen float32 under deterministic algorithms: 2 driver
        steps on (2, 2), saved by a `FaultManager` under
        build/lm_mesh_ckpt (removed after) and restored bit-equal,
        `elastic_reshard` onto (1, 4) and (1, 1) bit-equal gathered, 2
        more steps on each bit-equal to the same steps from the gathered
        state placed directly
     d. reduced qwen float32, one driver step over (pod=2, data=2,
        model=2) under `fsdp_over_pod` off and on, against one device
        within 13a's gates
  5. one {"kernels": [...]} line (K1's and K2's rows also carry phase 8's
     shard_launches, shard_ms and shard_bound_ms, and phase 9d's
     train_launches; K1's also phase 10a's driver_launches; every row
     phase 13's lm_mesh_launches, 0), the card
     line, and as the last line {"ok": true, "device": {...}}

Exits non-zero without printing a result when CUDA is unavailable or any
phase fails. `--json PATH` also writes every measurement to PATH.
`--passes-only` runs phases 1 and 4c alone and prints their sums as its
last line; `--sessions-only` runs phases 1 and 4g; `--lod-only` runs
phases 1 and 7; `--shards-only` runs phases 1 and 8 (rendering 8d's
plain frames itself); `--train-only` runs phases 1 and 9; `--serve-only`
runs phases 1 and 10; `--families-only` phases 1 and 11; `--lm-train-only`
phases 1 and 12; `--lm-mesh-only` phases 1 and 13; `--offpath-only` runs
phase 1, the 1024² setup,
phase 6a and K3 on the 1024² frame's lists, and prints their times on
the line before the card line and the contract's last line. A copy of this script placed
at the root of another commit's tree (`git archive`) times that commit's
kernels on the same operands, so one chip call can run parent, change,
change, parent, each in its own process. K1, K2 and K3's `ms` are device
times from CUDA graph replays; K4's are CUDA-event times around
back-to-back calls, which its milliseconds of device work dwarf the host
time of.

Byte bounds count what the call's data needs: K1 reads every lhs and the
features of valid entries only and writes every flag; K2 reads the
entries of the K-blocks it runs, the pixel centres of the tiles that run
at least one, and the carried state, and writes every output; K3 reads
every slot's mask bytes, the features and colour of the entries with a
set lane and the pixel centres, and writes every output; K4 writes every
flag (its operands are a few MB). Operation bounds count the lanes or
pairs the data needs.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Phase 9e runs under deterministic algorithms, which refuse cuBLAS
# matmuls unless this is set before the first one.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import (FULL_FP32, MIXED, GridConfig,  # noqa: E402
                              RasterConfig, RenderPlan, Renderer,
                              StreamConfig, TestConfig, default_camera,
                              load_ply, measure_k_max, orbit_camera,
                              project, psnr, random_scene, save_ply, ssim,
                              tile_fingerprints)
from repro_torch.core import GaussianScene, RenderConfig, training  # noqa: E402
from repro_torch.core.clustering import kmeans_clusters  # noqa: E402
from repro_torch.core.culling import aabb_mask, tile_chunk  # noqa: E402
from repro_torch.core.pruning import contribution_scores  # noqa: E402
from repro_torch.core.renderer import next_pow2  # noqa: E402
from repro_torch.lod import (LODConfig, build_lod,  # noqa: E402
                             gather_subscene, measure_lod_k_max,
                             select_clusters, selected_members,
                             selection_bucket_for)
from repro_torch.core.cat import leader_corners  # noqa: E402
from repro_torch.core.hierarchy import count_true  # noqa: E402
from repro_torch.core.raster import entry_mask_from_dense, untile  # noqa: E402
from repro_torch.core.precision import PrecisionScheme, _quant  # noqa: E402
from repro_torch.core.raster import (COMPACT_CHUNK_ELEMS, T_EPS,  # noqa: E402
                                    entry_alpha)
from repro_torch.core.renderer import StreamOverflowWarning  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.camera import resize_camera  # noqa: E402
from repro_torch.core.hierarchy import fold_frames  # noqa: E402
from repro_torch.kernels import build, ops, prtu, render  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.coherence import camera_delta  # noqa: E402
from repro_torch.distributed import (FaultConfig, FaultManager,  # noqa: E402
                                     ShardDropInjector,
                                     render_with_shard_recovery)
from repro_torch.distributed import sharding as D  # noqa: E402
from repro_torch.distributed.fault import elastic_reshard  # noqa: E402
from repro_torch.distributed.sharding import Mesh, Sharded  # noqa: E402
from repro_torch.models import pspec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import (HD_SCENE_KW, AdmissionRejected,  # noqa: E402
                                 RenderEngine, RenderRequest, Scheduler,
                                 Telemetry, hd1080_cameras, hd1080_engine,
                                 max_batch_for, open_loop_trace,
                                 register_hd1080_scene, replay_open_loop)
from repro_torch.serving.sharding import tile_mesh  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.launch import serve as serve_driver  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import tokens as lm_data  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import blocks as blocks_mod  # noqa: E402
from repro_torch.models import parity  # noqa: E402
from repro_torch.models import mamba2 as mamba_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.pspec import leaves  # noqa: E402
from repro_torch.serving.workloads import (arrival_camera,  # noqa: E402
                                           hd1080_plan, trajectory_cameras)

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
QUANT_CHUNK = 1 << 28                # float32 patterns per rounding check
# Bytes per list entry K1 must read when it is valid (mu 8, conic 12,
# spiky 1; lhs is read for every entry) and K2 per entry of a K-block it
# runs (features 24: mean, conic and opacity, feat[..., 0:6], the rest of
# the 32-byte row is padding; colour 12, valid 1, allow 16).
K1_VALID_ENTRY_BYTES = 21
K2_ENTRY_BYTES = 53
# Bytes K3 must read per list slot (allow 16, valid 1) and per entry with a
# set lane (features 24, colour 12), and write per pixel (rgb 12, T 4).
K3_SLOT_BYTES = 17
K3_ENTRY_BYTES = 36
K3_PIXEL_BYTES = 16
PASS_REPS = 20                       # CUDA graph replays per device time
K4_TAKES_WIDTH = "width" in inspect.signature(prtu.prtu_cat_mask).parameters


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


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn` over `reps` replays of a CUDA
    graph of it: a short kernel timed with CUDA events around back-to-back
    wrapper calls measures the wrapper's host time instead, and the graph
    leaves that out (each replay adds only its launch, a few
    microseconds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm-up: build, load, allocate
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    graph.reset()
    return ms


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
# Phase 1b: the kernels' rounding steps over every float32
# ---------------------------------------------------------------------------

def phase_quant() -> dict:
    """alg1.cuh's fp8 and fp16 rounding (one value and paired) against the
    plain quantizer over all 2**32 float32 bit patterns: equal bits, or
    both NaN."""
    dev = torch.device("cuda")
    result = {}
    for kind in ("fp8", "fp16"):
        for paired in (False, True):
            bad = 0
            for start in range(-(1 << 31), 1 << 31, QUANT_CHUNK):
                bits = torch.arange(start, start + QUANT_CHUNK,
                                    dtype=torch.int64, device=dev)
                x = bits.to(torch.int32).view(torch.float32)
                del bits
                got = prtu.alg1_quant(x, kind, paired=paired)
                want = _quant(x, kind)
                same = (got.view(torch.int32) == want.view(torch.int32)) \
                    | (got.isnan() & want.isnan())
                bad += int((~same).sum())
                del x, got, want, same
            name = f"{kind}_{'paired' if paired else 'single'}"
            result[name] = bad
            log(f"[quant] {name}: {bad} mismatches over 2**32 float32 "
                "patterns")
    check(not any(result.values()), f"rounding mismatches: {result}")
    return result


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
    result["tests"] = lists.numel() * 16
    for name in ("fp32", "mixed"):
        check(result[f"flips_{name}"] == 0, "K1 differs from its plain "
              f"version ({name})")
    result["max_abs_err"] = float(result["flips_mixed"])

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
    result["ms"] = device_ms(
        lambda: prtu.prtu_entry_cat_mask(*operands, **kw), PASS_REPS)
    result["plain_ms"] = time_ms(
        lambda: prtu.prtu_entry_cat_mask_plain(*operands, **kw), 3)
    result["bound_ms"], result["bound_by"] = k1_bound(operands)
    n_valid = int(torch.isfinite(operands[5]).sum())
    log(f"[k1] {result['ms']:.4f} ms/pass (plain {result['plain_ms']:.2f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{lists.numel()} entries, {n_valid} valid")
    return result


def k1_bound(operands) -> tuple[float, str]:
    """K1's bound on `operands`: every lhs read and every flag written,
    the features of valid (finite-lhs) entries read, and their tests."""
    p_top, p_bot, origins, _, _, lhs, _ = operands
    n_valid = int(torch.isfinite(lhs).sum())
    n_bytes = (nbytes(p_top, p_bot, origins, lhs) + lhs.numel() * 16
               + n_valid * K1_VALID_ENTRY_BYTES)
    return bound_ms(n_bytes, n_valid * 16 * K1_OPS_PER_TEST)


# ---------------------------------------------------------------------------
# Phase 3: K2
# ---------------------------------------------------------------------------

def near_tie_tiles(operands, tiles, t0=None) -> torch.Tensor:
    """Min |T - T_EPS| over every pixel and entry the plain blend visits in
    `tiles` (the only place a kernel/plain counter mismatch may sit),
    starting from the carried transmittance `t0` (ones when None)."""
    pix, feat, _, valid, allow = (x[tiles] for x in operands)
    mt = render.pixel_minitile_index(pix.shape[1], allow.shape[2],
                                     pix.device)
    trans = (torch.ones(pix.shape[:2], device=pix.device) if t0 is None
             else t0[tiles].clone())
    closest = torch.full((len(tiles),), float("inf"), device=pix.device)
    for k in range(feat.shape[1]):
        closest = torch.minimum(closest,
                                (trans - T_EPS).abs().min(dim=1).values)
        lane = (valid[:, k, None] != 0) & (allow[:, k][:, mt] != 0)
        a = entry_alpha(pix, feat[:, k, 0:2], feat[:, k, 2:5], feat[:, k, 5],
                        lane)
        trans = trans * (1.0 - a)
    return closest


def compare_fused(got, want, operands, label: str, t0=None) -> float:
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
        closest = near_tie_tiles(operands, tiles, t0)
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

    result["ms"] = device_ms(
        lambda: render.blend_tiles_fused(*operands, kblock_bound=kb,
                                         init=init), PASS_REPS)
    result["plain_ms"] = time_ms(
        lambda: render.blend_tiles_fused_plain(*operands, kb, *init), 2)
    chunks = int(got.kblocks_processed.sum())
    result["bound_ms"], result["bound_by"], lanes = k2_bound(
        operands, kb, init, got)
    result["kblocks_processed"] = chunks
    result["kblocks_total"] = t * got.kblocks_total
    result["lanes"] = lanes
    log(f"[k2] {result['ms']:.4f} ms/pass (plain {result['plain_ms']:.1f} "
        f"ms), bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{chunks} of {t * got.kblocks_total} K-blocks run, {lanes} "
        "pixel-entry lanes needed")
    return result


def k2_bound(operands, kb, init, got) -> tuple[float, str, int]:
    """K2's bound on one call: read the entries of the K-blocks it ran,
    the pixel centres of the tiles that ran one or more, the bounds and
    the carried state; write every output; the operations of the lanes
    it needs (the set mini-tile bits of the entries some pixel of the
    tile was still alive for). Returns (ms, "bytes" or "operations",
    lanes)."""
    pix, feat, _, valid, allow = operands
    entries = int((got.kblocks_processed.long() * render.K_BLK)
                  .clamp(max=feat.shape[1]).sum())
    running = int((got.kblocks_processed > 0).sum())
    out_bytes = nbytes(got.rgb, got.trans, got.processed, got.blended,
                       got.kblocks_processed) + got.entry_alive.numel()
    n_bytes = (nbytes(pix[0]) * running + nbytes(kb, *init)
               + entries * K2_ENTRY_BYTES + out_bytes)
    lanes = blend_lanes(pix, allow, got.entry_alive & (valid != 0))
    ms, by = bound_ms(n_bytes, lanes * K2_OPS_PER_LANE)
    return ms, by, lanes


# ---------------------------------------------------------------------------
# K3: against its plain version (hd1080 pass 0 here, the 1024² frame in
# phase 6d), and against K2
# ---------------------------------------------------------------------------

def k3_against_plain(operands, label: str) -> dict:
    """K3 within 1e-6 of its plain version on `operands`; its device ms
    (CUDA graph replays), plain ms and bound there, and the lane slots its
    walk issues against the lanes the data needs."""
    pix, feat, _, valid, allow = operands
    got = render.blend_tiles(*operands)
    want = render.blend_tiles_plain(*operands)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= 1e-6, f"K3 ({label}) differs from its plain version by "
          f"{err}")
    result = {"max_abs_err": err}
    result["ms"] = device_ms(lambda: render.blend_tiles(*operands),
                             PASS_REPS)
    result["plain_ms"] = time_ms(lambda: render.blend_tiles_plain(*operands),
                                 1)
    t, k = valid.shape
    n_valid = int((valid != 0).sum())
    result["bound_ms"], result["bound_by"], lanes = k3_bound(operands)
    result["lanes"] = lanes
    result["lane_slots"] = k3_lane_slots(valid, allow)
    log(f"[k3] {label}: max |Δ| rgb/trans vs plain {err:.3g}; "
        f"{result['ms']:.4f} ms/pass (plain {result['plain_ms']:.1f} ms), "
        f"bound {result['bound_ms']:.4f} ms by {result['bound_by']}; "
        f"{t * k} slots swept, {n_valid} valid, {lanes} pixel-entry lanes "
        f"needed, {result['lane_slots']} lane slots issued")
    return result


def k3_bound(operands) -> tuple[float, str, int]:
    """K3's bound on one call: read every slot's allow bytes and valid
    byte, the features and colour of each entry with a set lane, and the
    pixel centres; write every pixel's rgb and T; the operations of the
    lanes the data needs. Returns (ms, "bytes" or "operations", lanes)."""
    pix, _, _, valid, allow = operands
    entries = (valid != 0) & (allow != 0).any(dim=2)
    n_bytes = (valid.numel() * K3_SLOT_BYTES
               + int(entries.sum()) * K3_ENTRY_BYTES + nbytes(pix)
               + pix.shape[0] * pix.shape[1] * K3_PIXEL_BYTES)
    lanes = blend_lanes(pix, allow, valid != 0)
    ms, by = bound_ms(n_bytes, lanes * K3_OPS_PER_LANE)
    return ms, by, lanes


def k3_lane_slots(valid, allow) -> int:
    """Lane slots K3's walk issues on these masks: 32 for each entry of a
    tile and warp whose mini-tile pair {2w, 2w+1} has either bit set."""
    bits = (allow != 0) & (valid != 0)[:, :, None]            # (T, K, 16)
    pairs = bits.view(*bits.shape[:2], -1, 2).any(3)          # (T, K, 8)
    return int(pairs.sum(dtype=torch.int64)) * 32


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

def serve_in_batches(engine, requests) -> list:
    """Serve `requests` as the engine's batches (at most max_batch each);
    one list of FrameResults per dispatch."""
    step = engine.max_batch
    return [engine.render_batch(requests[i:i + step])
            for i in range(0, len(requests), step)]


def plain_renderer(plan) -> Renderer:
    """`plan` with the all-"torch" backend and the unfused blend: the plain
    versions of K1 and K2 on the card, everything else the same."""
    return Renderer.from_plan(plan).replace(
        test=TestConfig(backend="torch"), raster=RasterConfig())


def plain_render(engine, name, cam):
    """The all-"torch" plan's render of `cam` on the engine's scene."""
    plan = engine.plan_for(name, cam.height, cam.width)
    out, _ = plain_renderer(plan).render_with_stats(engine.scene(name),
                                                    cam.to(engine.device))
    return out


def held_to_plain(got, want, label: str) -> float:
    """Max |Δ| of image and alpha between a frame through K1 and K2 and the
    plain plan's frame of the same inputs; fails above 2e-4 (phase 4's
    tolerance)."""
    err = max(float((got.image - want.image).abs().max()),
              float((got.alpha - want.alpha).abs().max()))
    check(err <= 2e-4, f"{label}: frame differs from the plain plan's by "
          f"{err} (> 2e-4)")
    return err


def phase_serve(engine, name) -> dict:
    cams = hd1080_cameras(N_REQUESTS)
    requests = [RenderRequest(name, c, request_id=i)
                for i, c in enumerate(cams)]
    prtu.launches = render.launches = 0
    t0 = time.perf_counter()
    dispatches = serve_in_batches(engine, requests)
    wall = time.perf_counter() - t0
    launches = {"prtu_entry_cat_mask": prtu.launches,
                "blend_tiles_fused": render.launches}
    # One K1 and one K2 launch per pass of each dispatch, whatever its
    # batch size.
    passes = sum(d[0].passes_run for d in dispatches)
    results = [r for d in dispatches for r in d]
    rows, plain_images = [], {}
    for r, cam in zip(results, cams):
        c = {k: float(v) for k, v in r.counters.items()}
        check(r.image.shape == (cam.height, cam.width, 3), "frame shape")
        check(bool(torch.isfinite(r.image).all()), "non-finite pixels")
        check(not r.overflow, "a SPILL frame reported overflow")
        ref = plain_render(engine, name, cam)
        plain_images[r.request.request_id] = ref.image
        q = float(psnr(r.image, ref.image))
        err = float((r.image - ref.image).abs().max())
        check(err <= 2e-4, f"request {r.request.request_id}: frame differs "
              f"from the plain render by {err} (PSNR {q:.2f} dB)")
        row = dict(request=r.request.request_id, wall_s=r.render_s,
                   batch_size=r.batch_size, passes_run=r.passes_run,
                   spill_passes=c["spill_passes"],
                   processed_per_pixel=c["processed_per_pixel"],
                   kblocks_processed=c["kblocks_processed"],
                   kblocks_total=c["kblocks_total"], psnr_db=q,
                   max_abs_err=err, counters=c)
        rows.append(row)
        log(f"[serve] request {row['request']}: batch of {r.batch_size}, "
            f"{r.render_s * 1e3:.1f} ms the batch, "
            f"{int(c['spill_passes'])} of {r.passes_run} spill passes used, "
            f"processed/px {c['processed_per_pixel']:.2f}, K-blocks "
            f"{int(c['kblocks_processed'])}/{int(c['kblocks_total'])}, "
            f"PSNR vs plain {q:.2f} dB (max |Δ| {err:.2e})")
    log(f"[serve] {N_REQUESTS} requests in {len(dispatches)} dispatches "
        f"(max_batch {engine.max_batch}), {wall:.3f} s; launches "
        f"{launches} for {passes} passes of the dispatches "
        f"({engine.spill_retries} spill retries)")
    for kname, n in launches.items():
        check(n == passes, f"{kname} launched {n} times for {passes} "
              "dispatch passes")
        check(n > 0, f"{kname} never launched on the main path")
    return dict(requests=rows, wall_s=wall, launches=launches,
                passes=passes, dispatches=len(dispatches),
                plain_images=plain_images)


# ---------------------------------------------------------------------------
# Phase 4b: where a request's time goes
# ---------------------------------------------------------------------------

def sync_wall_ms(fn):
    """(result, ms) of `fn`, device-synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stage_walls(plan, scene, cam, label: str) -> dict:
    """Stage walls in ms of one warm frame of `plan`, device-synchronized
    around each stage."""
    plan.render_with_stats(scene, cam, enforce=False)           # warm-up
    _, total = sync_wall_ms(lambda: plan.render_with_stats(
        scene, cam, enforce=False))
    ps, pre = sync_wall_ms(lambda: plan.preprocess(scene, cam))
    streams, s1 = sync_wall_ms(lambda: plan.stage1_compact(ps))
    houts, ctu = sync_wall_ms(lambda: [plan.ctu(ps, ts) for ts in streams])
    _, blend = sync_wall_ms(lambda: plan._blend_passes(ps, houts))
    stages = dict(preprocess=pre, stage1_compact=s1, ctu=ctu, blend=blend,
                  rest=total - pre - s1 - ctu - blend, total=total)
    log(f"[{label}] ms per stage, " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items())
        + f" ({plan.n_passes} passes)")
    return stages


def phase_breakdown(engine, name) -> dict:
    """Stage walls of one warm frame, and the device's busy share under
    torch.profiler."""
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
# Phase 4c: K1 and K2 on every pass of a frame
# ---------------------------------------------------------------------------

def phase_passes(plan, scene, cam) -> dict:
    """Every pass of one frame: K1 equal to its plain version (FULL_FP32
    and MIXED), K2 against its plain version from the carried state, both
    timed against their bounds; then K1 on an all-empty pass."""
    ps = plan.preprocess(scene, cam)
    streams = plan.stage1_compact(ps)
    houts = [plan.ctu(ps, ts) for ts in streams]
    kw = prec_kw(MIXED)
    state = None
    rows = []
    for i, (ts, h) in enumerate(zip(streams, houts)):
        cat_ops = ops.entry_cat_operands(ps.proj, ps.grid, ts.lists,
                                         ts.valid)
        for name, p in (("fp32", FULL_FP32), ("mixed", MIXED)):
            got = prtu.prtu_entry_cat_mask(*cat_ops, **prec_kw(p))
            want = prtu.prtu_entry_cat_mask_plain(*cat_ops, **prec_kw(p))
            flips = int((got != want).sum())
            check(flips == 0, f"K1 pass {i}: {flips} flips ({name})")
        operands = ops.gather_tile_features(ps.proj, ps.grid, h.lists,
                                            h.valid, h.entry_mini_mask)
        kb = render.kblock_bound_of(operands[3])
        if state is None:
            t, p = operands[0].shape[:2]
            dev = operands[0].device
            state = (torch.ones((t, p), device=dev),
                     torch.zeros((t, p, 3), device=dev),
                     torch.zeros((t, p), device=dev),
                     torch.zeros((t, p), device=dev))
        got = render.blend_tiles_fused(*operands, kblock_bound=kb,
                                       init=state)
        want = render.blend_tiles_fused_plain(*operands, kb, *state)
        err = compare_fused(got, want, operands, f"pass {i}", t0=state[0])
        k1 = {"ms": device_ms(
            lambda: prtu.prtu_entry_cat_mask(*cat_ops, **kw), PASS_REPS)}
        k2 = {"ms": device_ms(lambda: render.blend_tiles_fused(
            *operands, kblock_bound=kb, init=state), PASS_REPS)}
        k1["bound_ms"], k1["bound_by"] = k1_bound(cat_ops)
        k2["bound_ms"], k2["bound_by"], _ = k2_bound(operands, kb, state,
                                                     got)
        row = dict(pass_index=i, valid=int(ts.valid.sum()),
                   kblocks_processed=int(got.kblocks_processed.sum()),
                   k2_max_abs_err=err, k1=k1, k2=k2)
        rows.append(row)
        log(f"[passes] pass {i}: {row['valid']} valid entries, "
            f"{row['kblocks_processed']} K-blocks run; K1 {k1['ms']:.4f} ms "
            f"(bound {k1['bound_ms']:.4f}), K2 {k2['ms']:.4f} ms (bound "
            f"{k2['bound_ms']:.4f})")
        state = (got.trans, got.rgb, got.processed, got.blended)
        del got, want

    # An all-empty pass: pass 0's operands with every slot invalid.
    cat_ops = list(ops.entry_cat_operands(ps.proj, ps.grid, streams[0].lists,
                                          streams[0].valid))
    cat_ops[5] = torch.full_like(cat_ops[5], float("-inf"))
    check(int(prtu.prtu_entry_cat_mask(*cat_ops, **kw).abs().sum()) == 0,
          "K1 hits on an all-empty pass")
    empty = {"ms": device_ms(
        lambda: prtu.prtu_entry_cat_mask(*cat_ops, **kw), PASS_REPS)}
    empty["bound_ms"], empty["bound_by"] = k1_bound(cat_ops)
    sums = {}
    for k in ("k1", "k2"):
        for field in ("ms", "bound_ms"):
            sums[f"{k}_{field}"] = sum(r[k][field] for r in rows)
    log(f"[passes] {len(rows)} passes: K1 {sums['k1_ms']:.3f} ms a frame "
        f"(bound {sums['k1_bound_ms']:.3f}), K2 {sums['k2_ms']:.3f} ms "
        f"(bound {sums['k2_bound_ms']:.3f}); K1 on an all-empty pass "
        f"{empty['ms']:.4f} ms (bound {empty['bound_ms']:.4f})")
    return dict(rows=rows, sums=sums, empty_k1=empty, passes=len(rows))


# ---------------------------------------------------------------------------
# Phases 4d-4f: the batched serving path, its spans, the scheduler
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    prtu.launches = render.launches = 0


def launches_now() -> dict:
    return {"prtu_entry_cat_mask": prtu.launches,
            "blend_tiles_fused": render.launches}


def check_launches(label: str, passes: int) -> dict:
    """K1 and K2 each launched once per pass of the dispatches read since
    the last `reset_launches`."""
    launches = launches_now()
    for kname, n in launches.items():
        check(n == passes, f"{label}: {kname} launched {n} times for "
              f"{passes} dispatch passes")
        check(n > 0, f"{label}: {kname} never launched")
    return launches


def same_frame(a, b) -> bool:
    """Image, alpha and every counter bit for bit."""
    return (torch.equal(a.image, b.image) and torch.equal(a.alpha, b.alpha)
            and a.counters.keys() == b.counters.keys()
            and all(torch.equal(a.counters[k], b.counters[k])
                    for k in a.counters))


def device_profile(fn) -> tuple[float, list]:
    """(device-busy ms, [(kernel, ms), ...] by descending device time) of
    `fn` under torch.profiler, recording device activity only: a training
    step issues ~10^5 small ops, whose host-side events would cost the
    profiler minutes to collect and sum. Fails if no device time shows."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    check(busy > 0, "torch.profiler recorded no device time")
    return busy, rows


def device_busy_ms(fn) -> float:
    """Device-busy ms of `fn` under torch.profiler (device-side events)."""
    return device_profile(fn)[0]


def phase_batch(engine, name, plain_images) -> dict:
    """Requests 0 and 1 as one dispatch and each alone: one K1 and one K2
    launch per pass of the batch, each batched frame equal to its single
    render bit for bit and within 2e-4 of the plain render; walls and
    device-busy time of the batch against two single frames."""
    cams = hd1080_cameras(N_REQUESTS)[:2]
    reqs = [RenderRequest(name, c, request_id=i) for i, c in enumerate(cams)]
    check(engine.max_batch >= 2, f"max_batch {engine.max_batch} < 2")
    reset_launches()
    pair = engine.render_batch(reqs)
    launches = check_launches("batch", pair[0].passes_run)
    check(all(r.batch_size == 2 and r.bucket_size == 2 for r in pair),
          "the two requests were not served as one batch of 2")
    singles = [engine.render_batch([r])[0] for r in reqs]
    rows = []
    for r, s in zip(pair, singles):
        i = r.request.request_id
        check(same_frame(r, s), f"batched request {i} differs from the "
              "same request served alone")
        err = float((r.image - plain_images[i]).abs().max())
        check(err <= 2e-4, f"batched request {i} differs from the plain "
              f"render by {err}")
        rows.append(dict(request=i, max_abs_err=err))
    # Warm walls: the batch and the singles again, twice each, in turns.
    walls = {"batch_s": [], "single_s": []}
    for _ in range(2):
        walls["batch_s"].append(engine.render_batch(reqs)[0].render_s)
        walls["single_s"].append(
            [engine.render_batch([r])[0].render_s for r in reqs])
    busy_batch = device_busy_ms(lambda: engine.render_batch(reqs))
    busy_singles = device_busy_ms(
        lambda: [engine.render_batch([r]) for r in reqs])
    single_wall = sum(sum(w) for w in walls["single_s"]) / 4
    kernels = batch_pass_kernels(engine, name, cams)
    log(f"[batch] 2 x 1920x1088 in one dispatch: launches {launches} for "
        f"{pair[0].passes_run} passes; both frames bit-equal to the single "
        f"renders, max |Δ| vs plain {max(x['max_abs_err'] for x in rows):.2e}")
    log(f"[batch] walls: batch of 2 {walls['batch_s']} s, singles "
        f"{walls['single_s']} s; device busy: batch {busy_batch:.3f} ms, "
        f"two singles {busy_singles:.3f} ms")
    return dict(launches=launches, passes=pair[0].passes_run, rows=rows,
                walls=walls, single_wall_s=single_wall, kernels=kernels,
                device_busy_batch_ms=busy_batch,
                device_busy_two_singles_ms=busy_singles)


def batch_pass_kernels(engine, name, cams) -> dict:
    """K1 and K2 on pass 0 of the two frames folded into 2 × 8160 tiles,
    the operands the batch's first launches get: each against its plain
    version (K1 0 flips under MIXED, K2 as in phase 3) and timed against
    its bound."""
    plan = engine.plan_for(name, cams[0].height, cams[0].width)
    pss = [plan.preprocess(engine.scene(name), c.to(engine.device))
           for c in cams]
    tss = [plan.stage1_compact(ps)[0] for ps in pss]
    grid = pss[0].grid
    fold = fold_frames([ps.proj for ps in pss], grid)
    ids, valid = fold.ids([t.lists for t in tss]), fold.cat(
        [t.valid for t in tss])
    kw = prec_kw(MIXED)
    cat_ops = ops.entry_cat_operands(fold.proj, grid, ids, valid,
                                     tile_origins=fold.tile_origins)
    flips = int((prtu.prtu_entry_cat_mask(*cat_ops, **kw)
                 != prtu.prtu_entry_cat_mask_plain(*cat_ops, **kw)).sum())
    check(flips == 0, f"K1 on the folded pass: {flips} flips")
    houts = plan._ctu_frames(pss, fold, tss)
    operands = ops.gather_tile_features(
        fold.proj, grid, ids, valid,
        fold.cat([h.entry_mini_mask for h in houts]),
        tile_origins=fold.tile_origins)
    pix = operands[0]
    kb = render.kblock_bound_of(operands[3])
    t, p = pix.shape[:2]
    init = (torch.ones((t, p), device=pix.device),
            torch.zeros((t, p, 3), device=pix.device),
            torch.zeros((t, p), device=pix.device),
            torch.zeros((t, p), device=pix.device))
    got = render.blend_tiles_fused(*operands, kblock_bound=kb, init=init)
    want = render.blend_tiles_fused_plain(*operands, kb, *init)
    err = compare_fused(got, want, operands, "folded pass 0")
    k1 = {"ms": device_ms(lambda: prtu.prtu_entry_cat_mask(*cat_ops, **kw),
                          PASS_REPS), "flips": flips, "tiles": t}
    k2 = {"ms": device_ms(lambda: render.blend_tiles_fused(
        *operands, kblock_bound=kb, init=init), PASS_REPS),
        "max_abs_err": err}
    k1["bound_ms"], k1["bound_by"] = k1_bound(cat_ops)
    k2["bound_ms"], k2["bound_by"], _ = k2_bound(operands, kb, init, got)
    log(f"[batch] folded pass 0 ({t} tiles): K1 {k1['ms']:.4f} ms (bound "
        f"{k1['bound_ms']:.4f}, 0 flips vs plain), K2 {k2['ms']:.4f} ms "
        f"(bound {k2['bound_ms']:.4f}, max |Δ| vs plain {err:.2e})")
    return {"k1": k1, "k2": k2}


def phase_trace(engine, name) -> dict:
    """One request under an enabled Tracer: the reference's eager tree
    under the engine's dispatch spans, the ctu and blend deltas summing to
    the frame's counters, JSONL and Chrome trace files under build/."""
    cam = hd1080_cameras(N_REQUESTS)[0]
    req = RenderRequest(name, cam, request_id=0)
    reset_launches()
    with obs.use_tracer(obs.Tracer()) as tracer:
        r, = engine.render_batch([req])
    launches = check_launches("trace", r.passes_run)
    check(len(tracer.roots) == 1, f"{len(tracer.roots)} root spans")
    root, = tracer.roots
    n = engine.plan_for(name, cam.height, cam.width).n_passes
    check(root.name == "engine.render_batch"
          and [c.name for c in root.children] == ["jit_render"]
          and [c.name for c in root.children[0].children] == ["render"],
          "dispatch spans differ from engine.render_batch > jit_render > "
          "render")
    frame = root.children[0].children[0]
    names = [c.name for c in frame.children]
    want = (["preprocess", "stage1_compact"] + ["ctu"] * n + ["blend"] * n
            + ["finalize"])
    check(names == want, f"span tree {names} != the reference's {want}")
    for kind in ("ctu", "blend"):
        check([s.attrs["pass"] for s in frame.find(kind)] == list(range(n)),
              f"{kind} span passes out of order")
    c = {k: float(v) for k, v in r.counters.items()}
    pixels = cam.height * cam.width
    sums = dict(
        vru_pairs=sum(s.attrs["vru_pairs"] for s in frame.find("ctu")),
        ctu_pairs=sum(s.attrs["ctu_pairs"] for s in frame.find("ctu")),
        processed=sum(s.attrs["processed_delta"]
                      for s in frame.find("blend")),
        blended=sum(s.attrs["blended_delta"] for s in frame.find("blend")),
        entries_alive=sum(s.attrs["entries_alive"]
                          for s in frame.find("blend")))
    pairs = (("vru_pairs", sums["vru_pairs"], c["vru_pairs"]),
             ("ctu_pairs", sums["ctu_pairs"], c["ctu_pairs"]),
             ("processed", sums["processed"] / pixels,
              c["processed_per_pixel"]),
             ("blended", sums["blended"] / pixels, c["blended_per_pixel"]),
             ("entries_alive", sums["entries_alive"], c["ctu_stream_len"]))
    for key, got, want_v in pairs:
        check(abs(got - want_v) <= 1e-6 * max(abs(want_v), 1.0),
              f"span deltas of {key} sum to {got}, the frame has {want_v}")
    out_dir = os.path.join(ROOT, "build", "trace")
    os.makedirs(out_dir, exist_ok=True)
    n_jsonl = obs.write_jsonl(tracer, os.path.join(out_dir,
                                                   "hd1080_spans.jsonl"))
    n_chrome = obs.write_chrome_trace(
        tracer, os.path.join(out_dir, "hd1080_trace.json"))
    walls = {}
    for s in frame.children:
        walls.setdefault(s.name, []).append(s.wall_s * 1e3)
    stage_ms = {k: sum(v) for k, v in walls.items()}
    log(f"[trace] {len(names)} stage spans under render ({n} passes), "
        f"ctu/blend deltas sum to the frame's counters; {n_jsonl} spans to "
        f"build/trace/hd1080_spans.jsonl, {n_chrome} events to "
        "build/trace/hd1080_trace.json; launches " + str(launches))
    log("[trace] stage span walls, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + "; ctu per pass "
        + str([round(s.wall_s * 1e3, 3) for s in frame.find("ctu")])
        + ", blend per pass "
        + str([round(s.wall_s * 1e3, 3) for s in frame.find("blend")]))
    return dict(launches=launches, spans=len(tracer.spans()),
                stage_ms=stage_ms, span_sums=sums,
                render_wall_ms=frame.wall_s * 1e3)


FALLBACK = (544, 960)


def phase_scheduler(engine, name, single_wall_s: float) -> dict:
    """The open-loop trace through a Scheduler with a 544×960 fallback, at
    2x the single-request service rate and deadlines of 1.5 single walls:
    every arrival served or rejected, every degraded frame equal to the
    direct 544×960 render of its pose, the futures' counts equal to the
    telemetry's."""
    engine.telemetry = Telemetry(registry=obs.MetricsRegistry())
    sched = Scheduler(engine)
    sched.register_fallback(1088, 1920, *FALLBACK)
    deadline = 1.5 * single_wall_s
    rate = 2.0 / single_wall_s
    trace = open_loop_trace(16, seed=0, scenes=(name,),
                            resolutions=((1088, 1920),),
                            interactive_frac=0.75,
                            interactive_deadline_s=deadline)
    dispatch_passes = []
    serve = engine.render_batch

    def counted(requests):
        results = serve(requests)
        dispatch_passes.append(results[0].passes_run)
        return results
    engine.render_batch = counted
    reset_launches()
    try:
        t0 = time.perf_counter()
        out = replay_open_loop(sched, trace, rate_rps=rate)
        wall = time.perf_counter() - t0
    finally:
        engine.render_batch = serve
    launches = check_launches("scheduler", sum(dispatch_passes))
    # The replay's own window, before the checks below render more.
    snap = engine.telemetry.snapshot()
    served, rejected, degraded, missed = [], 0, [], 0
    for a, fut in out:
        check(fut.done(), "an arrival was neither served nor rejected")
        exc = fut.exception()
        if exc is not None:
            check(isinstance(exc, AdmissionRejected),
                  f"arrival failed with {exc!r}")
            rejected += 1
            continue
        res = fut.result()
        served.append(res)
        missed += res.deadline_missed
        if res.degraded:
            check(res.image.shape == (*FALLBACK, 3), "degraded frame shape")
            low = resize_camera(arrival_camera(a, engine.device),
                                width=FALLBACK[1], height=FALLBACK[0])
            direct, = serve([RenderRequest(name, low)])
            check(torch.equal(res.image, direct.image),
                  "a degraded frame differs from the direct 544x960 render")
            degraded.append(res)
    tele = engine.telemetry
    counts = dict(arrivals=len(trace), served=len(served),
                  rejected=rejected, degraded=len(degraded),
                  deadline_misses=missed)
    check(len(served) + rejected == len(trace), "arrivals lost")
    check((tele.total_requests, tele.total_rejected, tele.total_degraded,
           tele.total_deadline_misses) == (len(served), rejected,
                                           len(degraded), missed)
          and sched.degraded == len(degraded) and sched.rejected == rejected,
          f"futures {counts} disagree with telemetry "
          f"({tele.total_requests}, {tele.total_rejected}, "
          f"{tele.total_degraded}, {tele.total_deadline_misses})")
    log(f"[scheduler] 16 arrivals at {rate:.3f} req/s (2x the single "
        f"wall's rate), interactive deadline {deadline * 1e3:.1f} ms: "
        f"{counts}; {len(dispatch_passes)} dispatches, replay wall "
        f"{wall:.3f} s; launches {launches}")
    log(f"[scheduler] telemetry: p50 {snap['p50_ms']:.1f} / p95 "
        f"{snap['p95_ms']:.1f} / p99 {snap['p99_ms']:.1f} ms per batch, "
        f"{snap['fps']:.2f} frames/s on the card; tiers "
        f"{snap['tiers']}; perf model (the FLICKER ASIC, not the card): "
        f"{snap['modeled_fps']:.0f} fps")
    return dict(counts=counts, launches=launches,
                dispatches=len(dispatch_passes), replay_wall_s=wall,
                deadline_s=deadline, rate_rps=rate,
                snapshot={k: v for k, v in snap.items() if k != "counters"},
                modeled_asic_fps=snap["modeled_fps"])


# ---------------------------------------------------------------------------
# Phase 4g: frame-coherent sessions
# ---------------------------------------------------------------------------

SESSION_FRAMES = 4
DRIFT_STEP = 2 * math.pi / 262144
COHERENCE_KEYS = ("tiles_reused", "tiles_recompacted", "full_recompactions")


def session_cameras(width: int = 1920, height: int = 1088) -> dict:
    """The three sessions' camera paths: one pose repeated, a drift of
    2π/262144 a frame and the trajectory's default orbit of 2π/64."""
    pose = hd1080_cameras(1, width=width, height=height)[0]
    return {"static": [pose] * SESSION_FRAMES,
            "drift": trajectory_cameras(SESSION_FRAMES, width=width,
                                        height=height, step=DRIFT_STEP),
            "orbit": trajectory_cameras(SESSION_FRAMES, width=width,
                                        height=height)}


def session_engine() -> tuple:
    """An incremental engine on the hd1080 base plan (SPILL passes of 512,
    `max_batch_for(1088, 1920)`), with the 512k scene registered."""
    engine = RenderEngine(hd1080_plan(), device="cuda", incremental=True,
                          max_batch=max_batch_for(1088, 1920),
                          telemetry=Telemetry(registry=obs.MetricsRegistry()))
    return engine, register_hd1080_scene(engine)


def stage1_span(root) -> tuple:
    """(stage name, ms) of the frame's Stage-1 span and the probe's ms
    (the render_incremental wall outside its decision span)."""
    inc, = root.find("render_incremental")
    decision, = inc.children
    frame, = decision.find("render")
    s1 = [c for c in frame.children
          if c.name in ("stage1_incremental", "stage1_compact")]
    check(len(s1) == 1, "no single Stage-1 span under render")
    return (s1[0].name, s1[0].wall_s * 1e3,
            (inc.wall_s - decision.wall_s) * 1e3, frame.wall_s * 1e3)


def phase_sessions(engine, name, sessions: dict) -> dict:
    """Each session's frames in turn through an incremental engine: the
    coherence counters, Stage-1 and frame walls per frame, one K1 and one
    K2 launch a pass, each frame bit-equal to `render_with_stats`."""
    scene = engine.scene(name)
    height, width = sessions["static"][0].height, sessions["static"][0].width
    t = engine.plan_for(name, height, width).grid.make().num_tiles
    rows = {}
    for session, cams in sessions.items():
        prev = None
        rows[session] = []
        for i, cam in enumerate(cams):
            req = RenderRequest(name, cam, request_id=i, session=session)
            reset_launches()
            with obs.use_tracer(obs.Tracer()) as tracer:
                r, = engine.render_batch([req])
            launches = check_launches(f"{session} frame {i}", r.passes_run)
            c = {k: float(v) for k, v in r.counters.items()}
            s1_name, s1_ms, probe_ms, render_ms = stage1_span(
                tracer.roots[0])
            plan = engine.plan_for(name, height, width)
            want_out, want_c = plan.render_with_stats(
                scene, cam.to(engine.device), enforce=False)
            check(torch.equal(r.image, want_out.image)
                  and torch.equal(r.alpha, want_out.alpha),
                  f"{session} frame {i}: image or alpha differs from "
                  "render_with_stats")
            check(set(r.counters) - set(COHERENCE_KEYS) == set(want_c)
                  and all(torch.equal(r.counters[k], want_c[k])
                          for k in want_c),
                  f"{session} frame {i}: counters differ from "
                  "render_with_stats")
            check(int(c["tiles_reused"]) + int(c["tiles_recompacted"]) == t,
                  f"{session} frame {i}: tiles do not add up to {t}")
            check(bool(torch.isfinite(r.image).all()), "non-finite pixels")
            row = dict(frame=i, camera_delta=(
                camera_delta(prev, cam) if prev is not None else None),
                tiles_reused=int(c["tiles_reused"]),
                tiles_recompacted=int(c["tiles_recompacted"]),
                full_recompactions=int(c["full_recompactions"]),
                stage1=s1_name, stage1_ms=s1_ms, probe_ms=probe_ms,
                render_ms=render_ms, frame_ms=r.render_s * 1e3,
                passes_run=r.passes_run, spill_passes=c["spill_passes"],
                launches=launches)
            rows[session].append(row)
            delta = ("cold" if prev is None
                     else f"{row['camera_delta']:.3g}")
            log(f"[sessions] {session} frame {i}: camera delta {delta}, "
                f"reused {row['tiles_reused']} / recompacted "
                f"{row['tiles_recompacted']} of {t} tiles, full "
                f"{row['full_recompactions']}; {s1_name} {s1_ms:.1f} ms, "
                f"probe {probe_ms:.1f} ms, render {render_ms:.1f} ms, frame "
                f"{row['frame_ms']:.1f} ms; {r.passes_run} passes, launches "
                f"{launches}; bit-equal to render_with_stats")
            prev = cam
    for row in rows["static"][1:]:
        check(row["tiles_reused"] == t and row["full_recompactions"] == 0,
              f"static frame {row['frame']} reused {row['tiles_reused']} "
              f"of {t} tiles")
    for row in rows["orbit"]:
        check(row["full_recompactions"] == 1,
              f"orbit frame {row['frame']} did not fall back")
    # The probe's two parts on the static pose, CUDA events around 10
    # back-to-back calls (the fingerprint's nonzero syncs the host).
    cam = sessions["static"][0].to(engine.device)
    grid = engine.plan_for(name, height, width).grid.make()
    proj = project(scene, cam)
    probe = dict(project_ms=time_ms(lambda: project(scene, cam), 10),
                 fingerprint_ms=time_ms(
                     lambda: tile_fingerprints(proj, grid), 10))
    log(f"[sessions] probe parts on the static pose: project "
        f"{probe['project_ms']:.2f} ms, tile_fingerprints "
        f"{probe['fingerprint_ms']:.2f} ms")
    full_ms = [r["stage1_ms"] for rs in rows.values() for r in rs
               if r["stage1"] == "stage1_compact"]
    static_ms = [r["stage1_ms"] for r in rows["static"][1:]]
    log(f"[sessions] static frames 1-3 Stage 1 {[round(x, 1) for x in static_ms]} "
        f"ms against the full path's stage1_compact "
        f"{[round(x, 1) for x in full_ms]} ms")
    tele = engine.telemetry
    log(f"[sessions] telemetry totals: reused {tele.total_tiles_reused}, "
        f"recompacted {tele.total_tiles_recompacted}, full "
        f"{tele.total_full_recompactions}; session evictions "
        f"{engine.session_evictions}, spill retries {engine.spill_retries}")
    return dict(tiles=t, sessions=rows, probe=probe,
                static_stage1_ms=static_ms,
                full_stage1_ms=full_ms,
                totals=dict(reused=tele.total_tiles_reused,
                            recompacted=tele.total_tiles_recompacted,
                            full=tele.total_full_recompactions))


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


def k4_call(operands, kw, width):
    """K4 through its wrapper, told the image's width in mini-tiles where
    the wrapper takes it (a tree whose K4 reads rows as a band does not)."""
    extra = {"width": width} if K4_TAKES_WIDTH else {}
    return prtu.prtu_cat_mask(*operands, **kw, **extra)


def k4_pairs(operands, kw, width: int) -> tuple[int, int]:
    """(pairs K4 evaluates, pairs that can hit) on the mask of an image
    `width` mini-tiles wide, from the operands. A pair can hit unless its
    Gaussian is culled or, under a fp8 delta, its two leader x deltas, or
    its two leader y deltas, are NaN (|Δ| > 464 px after the coordinate
    quantization, fault F1). K4 evaluates the live columns of each
    DENSE_SIDE² region of mini-tiles, less those whose every x, or every y,
    in the region is such a pair of deltas."""
    p_top, p_bot, mu, _, lhs, _ = operands
    m, n = p_top.shape[0], mu.shape[0]
    live = torch.isfinite(lhs).to(torch.int64)
    if kw["delta_prec"] != "fp8":
        return m * int(live.sum()), m * int(live.sum())
    height = m // width
    side = getattr(prtu, "DENSE_SIDE", 8)
    q = lambda x: _quant(x, kw["coord_prec"])  # noqa: E731
    mq = q(mu)

    def far(top, bot, mu_a):                   # (len, N): both deltas NaN
        nan = lambda d: ~(d.abs() <= 464)      # noqa: E731
        return nan(q(top)[:, None] - mu_a) & nan(q(bot)[:, None] - mu_a)

    fx = far(p_top[:width, 0], p_bot[:width, 0], mq[:, 0])    # (W, N)
    fy = far(p_top[::width, 1], p_bot[::width, 1], mq[:, 1])  # (H, N)
    need = ((~fx).sum(0) * (~fy).sum(0) * live).sum()
    rx = (~fx.view(width // side, side, n).all(1)).sum(0)
    ry = (~fy.view(height // side, side, n).all(1)).sum(0)
    return int((rx * ry * live).sum()) * side * side, int(need)


def phase_k4(pt: dict) -> dict:
    plan, scene, cam = pt["plan"], pt["scene"], pt["cam"]
    ps = plan.preprocess(scene, cam)
    operands = ops.cat_mask_operands(ps.proj, ps.grid)
    width = ps.grid.width // ps.grid.minitile
    m, n = operands[0].shape[0], operands[2].shape[0]
    n_live = int(torch.isfinite(operands[4]).sum())
    result = {"rows": m, "columns": n, "live_columns": n_live}
    for name, p in (("fp32", FULL_FP32), ("mixed", MIXED)):
        kw = prec_kw(p)
        got = k4_call(operands, kw, width)
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
        evaluated, needed = k4_pairs(operands, kw, width)
        if not K4_TAKES_WIDTH:     # a K4 without regions evaluates them all
            evaluated = m * n
        if name == "mixed":
            check(needed == n_live * m - result["far_pairs"],
                  "K4's pair counts disagree with the far-pair count")
        ms = time_ms(lambda: k4_call(operands, kw, width), 10)
        # Every flag is written; the operations are those of the pairs
        # that can hit.
        bound, by = bound_ms(nbytes(*operands) + m * n,
                             needed * K1_OPS_PER_TEST)
        result[name] = dict(ms=ms, bound_ms=bound, bound_by=by,
                            pairs_evaluated=evaluated, pairs_needed=needed)
        log(f"[k4] {name}: {ms:.3f} ms/call, bound {bound:.4f} ms by {by}; "
            f"{evaluated} pairs evaluated, {needed} can hit ({m} mini-tiles "
            f"x {n} Gaussians, {n_live} in frustum)")
    kw = prec_kw(MIXED)
    result["max_abs_err"] = float(result["flips_mixed"])
    result["ms"] = result["mixed"]["ms"]
    result["bound_ms"] = result["mixed"]["bound_ms"]
    result["bound_by"] = result["mixed"]["bound_by"]
    result["plain_ms"] = time_ms(lambda: plain_dense_mask(operands, kw), 1)
    log(f"[k4] mixed: plain version {result['plain_ms']:.1f} ms/call")
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


# ---------------------------------------------------------------------------
# Phase 7: camera-dependent LOD at the reference's 4M-Gaussian rung
# ---------------------------------------------------------------------------

# The full LOD rung of the reference's scaling benchmark
# (benchmarks/scaling.py:396-415): its scene distribution, serve camera,
# probe set and LODConfig; the scene seed is the reference's key, n.
LOD_RUNG = dict(
    n=1 << 22, res=512, probe_res=128, fov=32.0, seed=1 << 22,
    scene_kw=dict(extent=10.0, scale_range=(-3.3, -2.7), stretch=3.0,
                  opacity_range=(-1.0, 3.0)),
    cfg=LODConfig(num_clusters=4096, probe_k_max=256, probe_passes=2,
                  min_bucket=4096, min_footprint_px=1.0, mass_floor=1e-6),
    engine_thetas=(0.0, 0.03))
LOD_KMEANS_SEED = 0                  # the generator k-means draws from
LOD_KEYS = ("lod_clusters_total", "lod_clusters_selected",
            "lod_gaussians_selected", "lod_selection_ratio", "lod_bucket")


def spill_plan(res: int, k: int):
    """The hd1080 serving plan at res² for a measured survivor bound k,
    sized as the engine sizes it: passes of min(512, k) entries, a power
    of two of them covering k."""
    base = hd1080_plan()
    k_pass = min(base.stream.k_max, k)
    passes = next_pow2(-(-k // k_pass))
    return dataclasses.replace(
        base, grid=GridConfig(res, res),
        stream=dataclasses.replace(base.stream, k_max=k_pass,
                                   max_spill_passes=passes))


def lod_cameras(rung: dict, res: int, thetas, dev) -> list:
    """res² cameras at the rung's fov: `default_camera` for theta None,
    else `orbit_camera(theta)`."""
    return [default_camera(res, res, rung["fov"], device=dev) if t is None
            else orbit_camera(t, res, res, fov_deg=rung["fov"], device=dev)
            for t in thetas]


def lod_ply_round_trip(rung: dict, dev) -> tuple:
    """The rung's scene drawn on `dev`, written with `save_ply` under
    build/lod/ and loaded back with `load_ply`: means, log-scales, quats
    and opacity bit-equal, colors within 1e-6 (the SH_C0 affine map, the
    reference's own round-trip contract). Returns (loaded scene, stats)."""
    gen = torch.Generator(dev).manual_seed(rung["seed"])
    drawn = random_scene(gen, rung["n"], device=dev, **rung["scene_kw"])
    path = os.path.join(ROOT, "build", "lod", f"lod_{rung['n']}.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    save_ply(drawn, path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    scene = load_ply(path, device=dev)
    load_s = time.perf_counter() - t0
    os.remove(path)
    for f in ("means", "log_scales", "quats", "opacity_logits"):
        check(torch.equal(getattr(scene, f), getattr(drawn, f)),
              f"PLY round trip changed {f}")
    color_err = float((scene.colors - drawn.colors).abs().max())
    check(color_err <= 1e-6, f"PLY round trip moved colors by {color_err}")
    log(f"[lod] PLY: {rung['n']} Gaussians, {size} bytes, save "
        f"{save_s:.2f} s, load {load_s:.2f} s; means/log_scales/quats/"
        f"opacity bit-equal, colors max |Δ| {color_err:.2e}")
    return scene, dict(bytes=size, save_s=save_s, load_s=load_s,
                       color_max_abs_err=color_err)


def lod_build(rung: dict, scene, probes, grid) -> tuple:
    """Phase 7a: `build_lod` twice from one generator seed, the two builds
    bit-equal; then its k-means and its probe scoring timed apart, warm
    like the second build, and the rest of that build (scene reorder,
    cluster mass) as the difference."""
    cfg, dev = rung["cfg"], scene.means.device
    builds, build_ms = [], []
    for _ in range(2):
        lod, ms = sync_wall_ms(lambda: build_lod(
            scene, probes, cfg, grid=grid,
            generator=torch.Generator(dev).manual_seed(LOD_KMEANS_SEED)))
        builds.append(lod)
        build_ms.append(ms)
    c = min(cfg.num_clusters, scene.n)
    cl, kmeans_ms = sync_wall_ms(lambda: kmeans_clusters(
        scene, c, iters=cfg.kmeans_iters,
        generator=torch.Generator(dev).manual_seed(LOD_KMEANS_SEED)))
    pgrid = grid.with_resolution(probes[0].height, probes[0].width).make()
    _, scores_ms = sync_wall_ms(lambda: contribution_scores(
        scene, probes, pgrid, k_max=cfg.probe_k_max,
        passes=cfg.probe_passes))
    rest_ms = build_ms[1] - kmeans_ms - scores_ms
    a, b = builds
    for f in ("member_cluster", "centers", "radii", "counts", "starts",
              "mass"):
        check(torch.equal(getattr(a, f), getattr(b, f)),
              f"two build_lod runs differ in {f}")
    for f in ("means", "log_scales", "quats", "opacity_logits", "colors"):
        check(torch.equal(getattr(a.scene, f), getattr(b.scene, f)),
              f"two build_lod runs differ in the member scene's {f}")
    check(torch.equal(a.counts, cl.counts.to(torch.int32)),
          "build_lod's clusters differ from kmeans_clusters' of the seed")
    largest = int(a.counts.max())
    log(f"[lod] 7a build: {a.n_clusters} clusters over {a.n_real} members "
        f"(padded {a.n_padded}, largest cluster {largest}); build_lod "
        f"{build_ms[0]:.1f} ms first, {build_ms[1]:.1f} ms warm, the two "
        f"builds bit-equal; warm split: k-means {kmeans_ms:.1f} ms, probe "
        f"scoring {scores_ms:.1f} ms ({len(probes)} probes at "
        f"{probes[0].width}²), the rest {rest_ms:.1f} ms")
    return a, dict(clusters=a.n_clusters, members=a.n_real,
                   padded=a.n_padded, largest_cluster=largest,
                   kmeans_ms=kmeans_ms, scores_ms=scores_ms,
                   rest_ms=rest_ms, build_ms=build_ms)


def lod_served_frame(rung: dict, scene, lod, grid, cam) -> dict:
    """Phase 7b: the served LOD frame against the full frame of the same
    camera: selection, k_max and passes, walls, device-busy ms, PSNR and
    SSIM, peak memory, K1 and K2 once a pass on each frame."""
    cfg = rung["cfg"]
    dev = scene.means.device
    sel = select_clusters(lod, cam, cfg)
    n_sel = int(selected_members(lod, sel))
    bucket = selection_bucket_for(n_sel, cfg, lod.n_padded)
    ratio = n_sel / rung["n"]
    k_full = measure_k_max(scene, [cam], grid=grid, cap=scene.n)
    k_lod = measure_lod_k_max(lod, [cam], cfg, grid=grid)
    full_plan = spill_plan(rung["res"], k_full)
    lod_plan = dataclasses.replace(
        spill_plan(rung["res"], k_lod),
        lod=dataclasses.replace(cfg, selection_bucket=bucket))
    frames, peak = {}, {}
    for label, plan, fn in (
            ("full", full_plan,
             lambda: full_plan.render_with_stats(scene, cam)),
            ("lod", lod_plan,
             lambda: lod_plan.render_lod_with_stats(lod, cam))):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frames[label] = fn()
        check_launches(f"lod 7b {label} frame", plan.n_passes)
        peak[label] = (torch.cuda.max_memory_allocated() / 2**30
                       if dev.type == "cuda" else 0.0)
    (out_full, _), (out_lod, c_lod) = frames["full"], frames["lod"]
    check(out_lod.image.shape == (rung["res"], rung["res"], 3)
          and bool(torch.isfinite(out_lod.image).all()),
          "the LOD frame is not a finite image of the serve resolution")
    check(int(c_lod["lod_gaussians_selected"]) == n_sel
          and int(c_lod["lod_bucket"]) == bucket,
          "the LOD frame's lod_* counters disagree with the selection")
    plain_err = {
        "full": held_to_plain(out_full, plain_renderer(full_plan)
                              .render_with_stats(scene, cam)[0],
                              "lod 7b full frame"),
        "lod": held_to_plain(out_lod, plain_renderer(lod_plan)
                             .render_lod_with_stats(lod, cam)[0],
                             "lod 7b LOD frame")}
    q = float(psnr(out_lod.image, out_full.image))
    s = float(ssim(out_lod.image, out_full.image))
    check(ratio < 1.0, f"selection ratio {ratio} is not below 1")
    check(q >= 30.0, f"LOD frame PSNR {q:.2f} dB < 30 dB against the full "
          "frame")
    with obs.use_tracer(obs.Tracer()) as tracer:
        lod_plan.render_lod_with_stats(lod, cam)
    s0 = tracer.roots[0]
    check(s0.name == "stage0_lod" and tracer.roots[1].name == "render",
          "the LOD render's roots are not stage0_lod, render")
    walls = {}
    for label, fn in (("full",
                       lambda: full_plan.render_with_stats(scene, cam)),
                      ("lod",
                       lambda: lod_plan.render_lod_with_stats(lod, cam))):
        fn()                                            # warm
        walls[label] = [sync_wall_ms(fn)[1] for _ in range(3)]
    sub, _ = gather_subscene(lod, sel, bucket)
    stages = dict(full=stage_walls(full_plan, scene, cam, "lod full frame"),
                  lod=stage_walls(lod_plan, sub, cam, "lod frame"))
    busy, top = {}, {}
    for label, fn in (
            ("full", lambda: full_plan.render_with_stats(scene, cam)),
            ("lod", lambda: lod_plan.render_lod_with_stats(lod, cam))):
        busy[label], rows = device_profile(fn)
        top[label] = rows[:6]
    speedup = min(walls["full"]) / min(walls["lod"])
    row = dict(clusters_total=lod.n_clusters,
               clusters_selected=int(sel.sum()), gaussians_selected=n_sel,
               selection_ratio=ratio, bucket=bucket, k_max_full=k_full,
               k_max_lod=k_lod, passes_full=full_plan.n_passes,
               passes_lod=lod_plan.n_passes,
               stage0_span_ms=s0.wall_s * 1e3,
               walls_ms=walls, stages_ms=stages, device_busy_ms=busy,
               top_device_ms=top,
               psnr_db=q, ssim=s, peak_gib=peak, speedup=speedup,
               max_abs_err_vs_plain=plain_err)
    log(f"[lod] 7b selected {row['clusters_selected']}/{lod.n_clusters} "
        f"clusters = {n_sel} Gaussians (ratio {ratio:.6f}, bucket "
        f"{bucket}); k_max {k_full} -> {k_lod}, passes "
        f"{full_plan.n_passes} -> {lod_plan.n_passes}")
    log(f"[lod] 7b stage0_lod span {row['stage0_span_ms']:.2f} ms; frame "
        f"walls ms full "
        f"{[round(x, 2) for x in walls['full']]}, LOD "
        f"{[round(x, 2) for x in walls['lod']]} (full/LOD {speedup:.2f}x; "
        "the reference's CPU gate is 5x); device busy full "
        f"{busy['full']:.2f} ms, LOD {busy['lod']:.2f} ms")
    for label in ("full", "lod"):
        log(f"[lod] 7b top device time, {label} frame: " + "; ".join(
            f"{k[:60]} {v:.2f} ms" for k, v in top[label][:4]))
    log(f"[lod] 7b LOD vs full: PSNR {q:.2f} dB, SSIM {s:.5f}; peak memory "
        f"full {peak['full']:.2f} GiB, LOD {peak['lod']:.2f} GiB; K1 and "
        "K2 once a pass on each frame; vs the plain plan's frame max |Δ| "
        f"full {plain_err['full']:.2e}, LOD {plain_err['lod']:.2e}")
    return dict(row, out_full=out_full, full_plan=full_plan)


def tile_rows(grid, x) -> torch.Tensor:
    """(H, W, ...) image -> (T, tile*tile*...) rows, one per tile."""
    grid = grid.make()
    t = grid.tile
    x = x.reshape(grid.tiles_y, t, grid.tiles_x, t, -1).transpose(1, 2)
    return x.reshape(grid.num_tiles, -1)


def lod_select_all(rung: dict, scene, lod, grid, cam, served: dict) -> dict:
    """Phase 7c: footprint and mass tests off, so selection is the
    conservative cluster cull. Every tile whose survivor lists hold the
    same Gaussians in the same order in the LOD frame and the full frame
    renders bit-equal; where the order differs the depths must agree
    entry by entry (a depth tie the build's reorder swapped: the stable
    depth sort keeps index order, and the reorder changed the indices)."""
    cfg = dataclasses.replace(rung["cfg"], min_footprint_px=0.0,
                              mass_floor=0.0)
    sel = select_clusters(lod, cam, cfg)
    n_sel = int(selected_members(lod, sel))
    bucket = selection_bucket_for(n_sel, cfg, lod.n_padded)
    plan = dataclasses.replace(
        served["full_plan"], lod=dataclasses.replace(
            cfg, selection_bucket=bucket))
    reset_launches()
    out, _ = plan.render_lod_with_stats(lod, cam)
    check_launches("lod 7c select-all frame", plan.n_passes)
    plain_err = held_to_plain(
        out, plain_renderer(plan).render_lod_with_stats(lod, cam)[0],
        "lod 7c select-all frame")
    full = served["out_full"]
    sub, _ = gather_subscene(lod, sel, bucket)

    def lists_and_keys(s):
        ps = plan.preprocess(s, cam)
        lists = torch.cat([ts.lists for ts in plan.stage1_compact(ps)],
                          dim=1).long()
        idx = lists.clamp_min(0)
        feat = torch.cat([s.means, s.opacity_logits[:, None], s.colors],
                         dim=1)[idx]
        return lists >= 0, feat, ps.proj.depth[idx]

    valid_f, feat_f, depth_f = lists_and_keys(scene)
    valid_s, feat_s, depth_s = lists_and_keys(sub)
    check(torch.equal(valid_f, valid_s),
          "a tile's survivor count differs between the LOD and full frame")
    differs = ((feat_f != feat_s).any(dim=2) & valid_f).any(dim=1)
    depth_same = ((depth_f == depth_s) | ~valid_f).all(dim=1)
    check(bool((depth_same | ~differs).all()),
          "a tile's lists differ beyond depth ties between the LOD and the "
          "full frame")
    same_px = ((tile_rows(grid, out.image) == tile_rows(grid, full.image))
               .all(dim=1) & (tile_rows(grid, out.alpha)
                              == tile_rows(grid, full.alpha)).all(dim=1))
    bad = int((~same_px & ~differs).sum())
    check(bad == 0, f"{bad} tiles without a swapped depth tie differ "
          "between the select-all LOD frame and the full frame")
    tied, tied_px = int(differs.sum()), int((differs & ~same_px).sum())
    log(f"[lod] 7c select-all: {int(sel.sum())}/{lod.n_clusters} clusters "
        f"= {n_sel} Gaussians (bucket {bucket}); {tied} of "
        f"{grid.make().num_tiles} tiles hold a depth tie the reorder swapped "
        f"({tied_px} of them differ in pixels); every other tile "
        "bit-equal to the full frame; vs the plain plan's frame max |Δ| "
        f"{plain_err:.2e}")
    return dict(clusters_selected=int(sel.sum()), gaussians_selected=n_sel,
                bucket=bucket, tiles=grid.make().num_tiles, tied_tiles=tied,
                tied_tiles_pixels_differ=tied_px,
                max_abs_err_vs_plain=plain_err)


def lod_engine(rung: dict, scene, dev) -> dict:
    """Phase 7d: a fresh engine on the hd1080 plan at res², the scene
    registered with lod= over three res² probe poses; one batch of two
    requests (K1 and K2 once a pass of the batch), its lod_* counters and
    gauges, each frame >= 30 dB against its full render; the same batch
    again a plan-cache hit, bit-identical."""
    res, cfg = rung["res"], rung["cfg"]
    engine = RenderEngine(
        dataclasses.replace(hd1080_plan(), grid=GridConfig(res, res)),
        device=dev, max_batch=2,
        telemetry=Telemetry(registry=obs.MetricsRegistry()))
    probes = lod_cameras(rung, res, (None, 0.06, -0.06), dev)
    t0 = time.perf_counter()
    entry = engine.register_scene("lod4m", scene, probe_cameras=probes,
                                  lod=cfg)
    register_s = time.perf_counter() - t0
    reqs = [RenderRequest("lod4m", c, request_id=i) for i, c in
            enumerate(lod_cameras(rung, res, rung["engine_thetas"], dev))]
    reset_launches()
    frames = engine.render_batch(reqs)
    launches = check_launches("lod 7d batch", frames[0].passes_run)
    check(all(f.batch_size == 2 for f in frames),
          "the two LOD requests were not served as one batch")
    # The batch's union sub-scene as the engine gathers it, and the plan it
    # rendered that with: each frame held against the plain plan's render.
    sub, bucket, _ = engine._lod_gather(entry, [r.camera for r in reqs])
    plain = plain_renderer(engine.plan_for("lod4m", res, res,
                                           lod_bucket=bucket))
    rows = []
    for f in frames:
        check(all(k in f.counters for k in LOD_KEYS),
              "an LOD frame lacks a lod_* counter")
        cam = f.request.camera
        err = held_to_plain(f, plain.render_with_stats(sub, cam)[0],
                            f"lod 7d engine frame {f.request.request_id}")
        k = measure_k_max(scene, [cam], grid=GridConfig(res, res),
                          cap=scene.n)
        full, _ = spill_plan(res, k).render_with_stats(scene, cam)
        q = float(psnr(f.image, full.image))
        check(q >= 30.0, f"engine LOD frame {f.request.request_id}: PSNR "
              f"{q:.2f} dB < 30 dB against its full render")
        rows.append(dict(request=f.request.request_id, psnr_db=q,
                         max_abs_err_vs_plain=err, **{
            k: float(f.counters[k]) for k in LOD_KEYS + ("n_gaussians",)}))
    text = engine.telemetry.registry.expose()
    for name in ("engine_scene_lod_clusters", "engine_lod_selection_ratio",
                 "engine_lod_clusters_selected",
                 "engine_lod_gaussians_selected",
                 "render_lod_selection_ratio"):
        check(name in text, f"gauge {name} missing after an LOD batch")
    compiles = engine.compile_count
    again = engine.render_batch(reqs)
    check(engine.compile_count == compiles,
          "the repeated LOD batch missed the plan cache")
    check(all(same_frame(a, b) for a, b in zip(frames, again)),
          "the repeated LOD batch is not bit-identical")
    log(f"[lod] 7d engine: registered in {register_s:.2f} s (k_max "
        f"{entry.k_max}, {entry.lod.n_clusters} clusters); batch of 2, "
        f"{frames[0].passes_run} passes, launches {launches}, wall "
        f"{frames[0].render_s * 1e3:.1f} ms (again "
        f"{again[0].render_s * 1e3:.1f} ms, a plan-cache hit, "
        "bit-identical); " + "; ".join(
            f"request {r['request']}: {int(r['lod_clusters_selected'])} "
            f"clusters, {int(r['lod_gaussians_selected'])} Gaussians, "
            f"bucket {int(r['lod_bucket'])}, PSNR {r['psnr_db']:.2f} dB, "
            f"vs the plain plan max |Δ| {r['max_abs_err_vs_plain']:.2e}"
            for r in rows))
    return dict(register_s=register_s, k_max=entry.k_max,
                passes=frames[0].passes_run, launches=launches,
                walls_ms=[frames[0].render_s * 1e3, again[0].render_s * 1e3],
                frames=rows)


def phase_lod(rung: dict = LOD_RUNG, dev=torch.device("cuda")) -> dict:
    """Phase 7: the rung's scene through PLY, the LOD build (7a), the
    served LOD frame against the full frame (7b), select-all (7c) and the
    engine's LOD path (7d)."""
    scene, ply = lod_ply_round_trip(rung, dev)
    grid = GridConfig(rung["res"], rung["res"])
    probes = lod_cameras(rung, rung["probe_res"], (None, 0.06, -0.06), dev)
    lod, build_row = lod_build(rung, scene, probes, grid)
    cam = default_camera(rung["res"], rung["res"], rung["fov"], device=dev)
    served = lod_served_frame(rung, scene, lod, grid, cam)
    select_all = lod_select_all(rung, scene, lod, grid, cam, served)
    for key in ("out_full", "full_plan"):
        served.pop(key)
    del lod
    engine = lod_engine(rung, scene, dev)
    return dict(ply=ply, build=build_row, served=served,
                select_all=select_all, engine=engine)


# ---------------------------------------------------------------------------
# Phase 8: tile-sharded and frame-sharded rendering, shard-drop recovery
# ---------------------------------------------------------------------------

TILE_SHARDS = 4
SHARD_DROP = (1, 3)
PROBE_SHARD = 2                      # the shard whose rows 8b times


def virtual_mesh(tiles: int, frames: int = 1, dev=None):
    """A (frames, tiles) mesh whose every device is this one card: the
    schedule of a multi-card mesh with each shard on the same card."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dev is None else dev
    return tile_mesh(tiles, frame_shards=frames,
                     devices=[dev] * (tiles * frames))


def shared_frame_equal(got, want) -> bool:
    """A sharded FrameResult against an unsharded one: image, alpha and
    every counter the unsharded frame has, bit for bit."""
    return (torch.equal(got.image, want.image)
            and torch.equal(got.alpha, want.alpha)
            and set(want.counters) <= set(got.counters)
            and all(torch.equal(got.counters[k], want.counters[k])
                    for k in want.counters))


def shard_engine(dev, shards: int, frames: int = 1, max_batch=None,
                 **scene_kw):
    """A fresh hd1080 engine on `dev`, tile-sharded `shards` ways over a
    virtual mesh of the card with `frames` data rows."""
    eng = RenderEngine(hd1080_plan(), device=dev,
                       max_batch=max_batch or max_batch_for(
                           scene_kw.get("height", 1088),
                           scene_kw.get("width", 1920)),
                       shard_tiles=shards,
                       mesh=virtual_mesh(shards, frames, dev))
    return eng, register_hd1080_scene(eng, **scene_kw)


def phase_shards(plain_images=None, dev=torch.device("cuda"),
                 **scene_kw) -> dict:
    """Phase 8 on the hd1080 configuration (scene_kw shrinks it, as
    `register_hd1080_scene` takes it): 8a the 4-shard frame against the
    unsharded one, 8b K1 and K2 on one shard's rows, 8c shard-drop
    recovery, 8d frame x tile. Every shard runs on this one card."""
    base, name = hd1080_engine(device=dev, **scene_kw)
    sharded, _ = shard_engine(dev, TILE_SHARDS, **scene_kw)
    cams = hd1080_cameras(N_REQUESTS, width=scene_kw.get("width", 1920),
                          height=scene_kw.get("height", 1088))
    reqs = [RenderRequest(name, c, request_id=i) for i, c in enumerate(cams)]
    frame = timed_phase("shards 8a", phase_shard_frame, base, sharded, name,
                        reqs)
    plan = sharded.plan_for(name, cams[0].height, cams[0].width)
    scene, cam = sharded.scene(name), cams[0].to(dev)
    kernels = timed_phase("shards 8b", phase_shard_kernels, plan, scene, cam)
    recovery = timed_phase("shards 8c", phase_shard_recovery, sharded, plan,
                           scene, cam, frame["base_frames"][0])
    del sharded
    composed = timed_phase("shards 8d", phase_frame_by_tile, base, name,
                           reqs, frame["base_frames"], plain_images, dev,
                           scene_kw)
    frame.pop("base_frames")
    return dict(frame=frame, kernels=kernels, recovery=recovery,
                frame_by_tile=composed)


def phase_shard_frame(base, sharded, name, reqs) -> dict:
    """8a: requests 1 and 0 through the unsharded and the 4-shard engine,
    each frame bit-equal; K1 and K2 launched 4 times a pass of request
    0's dispatch; the plan-level frames equal on every RenderOut field
    (entry_alive and the work maps included); the occupancy counters;
    warm walls and device-busy ms of both."""
    # Request 1 first: its lists overflow the first pass bucket on both
    # engines, which settles each on the same doubled bucket.
    base_frames = {}
    for r in (reqs[1], reqs[0]):
        want = base.render_batch([r])[0]
        if r is reqs[0]:
            reset_launches()
        got = sharded.render_batch([r])[0]
        i = r.request_id
        check(shared_frame_equal(got, want), f"sharded request {i} differs "
              "from the unsharded frame")
        base_frames[i] = want
    launches = launches_now()
    passes = got.passes_run
    for kname, n in launches.items():
        check(n == TILE_SHARDS * passes, f"sharded request 0: {kname} "
              f"launched {n} times for {passes} passes x {TILE_SHARDS} "
              "shards")
    plan = sharded.plan_for(name, reqs[0].camera.height,
                            reqs[0].camera.width)
    bplan = base.plan_for(name, reqs[0].camera.height, reqs[0].camera.width)
    check(dataclasses.replace(plan, shard=bplan.shard) == bplan,
          "the two engines settled on different plans")
    cam = reqs[0].camera.to(sharded.device)
    from repro_torch.distributed.sharding import use_mesh
    with use_mesh(sharded.mesh):
        s_out, s_c = plan.render_with_stats(sharded.scene(name), cam,
                                            enforce=False)
    b_out, b_c = bplan.render_with_stats(base.scene(name), cam,
                                         enforce=False)
    for field in b_out._fields:
        check(torch.equal(getattr(s_out, field), getattr(b_out, field)),
              f"sharded plan frame differs on {field}")
    check(all(torch.equal(s_c[k], b_c[k]) for k in b_c),
          "sharded plan counters differ")
    c = {k: float(got.counters[k]) for k in
         ("tile_shards", "shard_entries_max", "shard_entries_min")}
    check(c["tile_shards"] == TILE_SHARDS, f"tile_shards {c['tile_shards']}")
    walls = {"sharded_s": [], "unsharded_s": []}
    for _ in range(3):
        walls["unsharded_s"].append(base.render_batch([reqs[0]])[0].render_s)
        walls["sharded_s"].append(sharded.render_batch([reqs[0]])[0].render_s)
    busy, top = {}, {}
    for label, eng in (("unsharded", base), ("sharded", sharded)):
        busy[label + "_ms"], rows = device_profile(
            lambda: eng.render_batch([reqs[0]]))
        top[label] = rows[:12]
    ratio = c["shard_entries_max"] / max(c["shard_entries_min"], 1.0)
    log(f"[shards] 8a request 0 at {reqs[0].camera.width}x"
        f"{reqs[0].camera.height}, {TILE_SHARDS} virtual shards of one card:"
        f" bit-equal to the unsharded frame (image, alpha, entry_alive, work"
        f" maps, every counter); tile_shards {int(c['tile_shards'])}, "
        f"shard entries max {int(c['shard_entries_max'])} min "
        f"{int(c['shard_entries_min'])} (ratio {ratio:.3f}); launches "
        f"{launches} for {passes} passes x {TILE_SHARDS} shards")
    log(f"[shards] 8a warm walls s: sharded {walls['sharded_s']}, unsharded "
        f"{walls['unsharded_s']}; device busy ms: sharded "
        f"{busy['sharded_ms']:.3f}, unsharded {busy['unsharded_ms']:.3f}")
    for label, rows in top.items():
        log(f"[shards] 8a top device time, {label}: " + "; ".join(
            f"{k[:50]} {v:.2f} ms" for k, v in rows[:5]))
    return dict(launches=launches, passes=passes, counters=c,
                entries_ratio=ratio, walls=walls, device_busy=busy,
                top_device_ms=top, base_frames=base_frames)


def phase_shard_kernels(plan, scene, cam) -> dict:
    """8b: K1 and K2 on shard PROBE_SHARD's rows of pass 0, the operands
    that shard's first launches get (tile origins from mid-grid): K1 with
    0 flips under FULL_FP32 and MIXED, K2 against its plain version as in
    phase 3; device ms from CUDA graph replays against their bounds, and
    the plain versions' ms."""
    ps = plan.preprocess(scene, cam)
    ts = plan.stage1_compact(ps)[0]
    grid = ps.grid
    t = grid.num_tiles // TILE_SHARDS
    blk = slice(PROBE_SHARD * t, (PROBE_SHARD + 1) * t)
    dev = cam.fx.device
    fold = fold_frames([ps.proj], grid).on(dev, grid.tile_origins(dev)[blk])
    lists, valid = ts.lists[blk], ts.valid[blk]
    cat_ops = ops.entry_cat_operands(fold.proj, grid, lists, valid,
                                     tile_origins=fold.tile_origins)
    for pname, p in (("fp32", FULL_FP32), ("mixed", MIXED)):
        flips = int((prtu.prtu_entry_cat_mask(*cat_ops, **prec_kw(p))
                     != prtu.prtu_entry_cat_mask_plain(
                         *cat_ops, **prec_kw(p))).sum())
        check(flips == 0, f"K1 on shard {PROBE_SHARD}'s rows: {flips} "
              f"flips ({pname})")
    kw = prec_kw(MIXED)
    mini, _, _ = plan._ctu_tile_rows(fold, grid, [lists], [valid])
    operands = ops.gather_tile_features(fold.proj, grid, lists, valid, mini,
                                        tile_origins=fold.tile_origins)
    pix = operands[0]
    kb = render.kblock_bound_of(operands[3])
    p = pix.shape[1]
    init = (torch.ones((t, p), device=dev),
            torch.zeros((t, p, 3), device=dev),
            torch.zeros((t, p), device=dev),
            torch.zeros((t, p), device=dev))
    got = render.blend_tiles_fused(*operands, kblock_bound=kb, init=init)
    want = render.blend_tiles_fused_plain(*operands, kb, *init)
    err = compare_fused(got, want, operands, f"shard {PROBE_SHARD} pass 0")
    k1 = {"ms": device_ms(lambda: prtu.prtu_entry_cat_mask(*cat_ops, **kw),
                          PASS_REPS),
          "plain_ms": time_ms(lambda: prtu.prtu_entry_cat_mask_plain(
              *cat_ops, **kw), 1), "max_abs_err": 0.0}
    k2 = {"ms": device_ms(lambda: render.blend_tiles_fused(
        *operands, kblock_bound=kb, init=init), PASS_REPS),
        "plain_ms": time_ms(lambda: render.blend_tiles_fused_plain(
            *operands, kb, *init), 1), "max_abs_err": err}
    k1["bound_ms"], k1["bound_by"] = k1_bound(cat_ops)
    k2["bound_ms"], k2["bound_by"], _ = k2_bound(operands, kb, init, got)
    origin = [int(x) for x in fold.tile_origins[0].tolist()]
    log(f"[shards] 8b shard {PROBE_SHARD} pass 0 ({t} tiles, first origin "
        f"{origin}, {int(valid.sum())} valid entries): K1 {k1['ms']:.4f} ms "
        f"(bound {k1['bound_ms']:.4f}, plain {k1['plain_ms']:.2f}, 0 flips)"
        f", K2 {k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, plain "
        f"{k2['plain_ms']:.2f}, max |Δ| {err:.2e})")
    return dict(tiles=t, first_origin=origin, k1=k1, k2=k2)


def phase_shard_recovery(sharded, plan, scene, cam, want) -> dict:
    """8c: `render_with_shard_recovery` with shards SHARD_DROP dropped:
    their tiles re-rendered and spliced under the parity gate, the frame
    equal to the engine's; recovery wall against the healthy frame's; the
    injector's next frame healthy."""
    mesh = sharded.mesh

    def run(injector):
        return sync_wall_ms(lambda: render_with_shard_recovery(
            plan, scene, cam, injector=injector, mesh=mesh))

    walls = {"healthy_ms": [], "recovery_ms": []}
    for _ in range(2):
        walls["healthy_ms"].append(run(ShardDropInjector())[1])
        walls["recovery_ms"].append(
            run(ShardDropInjector(drop=SHARD_DROP))[1])
    inj = ShardDropInjector(drop=SHARD_DROP)
    (out, c, report), _ = run(inj)
    n_tiles = plan.grid.make().num_tiles
    lost = len(SHARD_DROP) * n_tiles // TILE_SHARDS
    check(report.dropped_shards == SHARD_DROP and report.parity_ok
          and report.tiles_recovered == lost,
          f"recovery report {report}, expected {lost} tiles")
    check(float(c["shard_drops"]) == len(SHARD_DROP)
          and float(c["tiles_recovered"]) == lost, "recovery counters")
    check(torch.equal(out.image, want.image)
          and torch.equal(out.alpha, want.alpha),
          "the recovered frame differs from the engine's frame")
    (out2, c2, report2), _ = run(inj)
    check(report2.dropped_shards == () and float(c2["shard_drops"]) == 0.0
          and torch.equal(out2.image, want.image),
          "the frame after the drop is not healthy")
    log(f"[shards] 8c dropped shards {SHARD_DROP}: {report.tiles_recovered} "
        f"tiles recovered, parity gate held; walls ms: recovery "
        f"{walls['recovery_ms']}, healthy {walls['healthy_ms']}; the next "
        "frame healthy (shard_drops 0)")
    return dict(tiles_recovered=report.tiles_recovered, walls=walls)


def phase_frame_by_tile(base, name, reqs, base_frames, plain_images, dev,
                        scene_kw) -> dict:
    """8d: a (2 frame x 2 tile) virtual mesh serves requests 0-2 as one
    batch (bucket 4, split 2 + 2 over the data rows): each frame bit-equal
    to the unsharded engine's and within 2e-4 of the all-"torch" plan's
    render, tile_shards 2; K1 and K2 launched 2 x 2 times a pass."""
    eng, _ = shard_engine(dev, 2, frames=2, max_batch=4, **scene_kw)
    reset_launches()
    got = eng.render_batch(reqs)
    launches = launches_now()
    passes = got[0].passes_run
    for kname, n in launches.items():
        check(n == 4 * passes, f"frame x tile: {kname} launched {n} times "
              f"for {passes} passes x 2 rows x 2 shards")
    check((got[0].batch_size, got[0].bucket_size) == (3, 4),
          f"batch {got[0].batch_size}, bucket {got[0].bucket_size}")
    rows = []
    for r, g in zip(reqs, got):
        i = r.request_id
        want = (base_frames[i] if i in base_frames
                else base.render_batch([r])[0])
        check(shared_frame_equal(g, want), f"frame x tile request {i} "
              "differs from the unsharded frame")
        check(float(g.counters["tile_shards"]) == 2.0, "tile_shards != 2")
        plain = (plain_images[i] if plain_images is not None else
                 plain_render(base, name, r.camera).image)
        err = float((g.image - plain).abs().max())
        check(err <= 2e-4, f"frame x tile request {i}: {err} from the "
              "plain render")
        rows.append(dict(request=i, max_abs_err=err,
                         entries_max=float(g.counters["shard_entries_max"]),
                         entries_min=float(g.counters["shard_entries_min"])))
    log(f"[shards] 8d 2 frame x 2 tile shards, batch of 3 in bucket 4: "
        f"every frame bit-equal to the unsharded engine's, max |Δ| vs plain "
        f"{max(r['max_abs_err'] for r in rows):.2e}; launches {launches} "
        f"for {passes} passes; wall {got[0].render_s:.3f} s")
    return dict(launches=launches, passes=passes, rows=rows,
                wall_s=got[0].render_s)


# ---------------------------------------------------------------------------
# Phase 9: scene training on the card, the trained scene served fused
# ---------------------------------------------------------------------------

# benchmarks/train_dataflow.py's gradient-parity fit: 64², 500 Gaussians.
TRAIN_GRADS = dict(res=64, n=500, seed=0, k_max=500,
                   scene_kw=dict(scale_range=(-2.8, -2.0), stretch=3.5,
                                 opacity_range=(-1.0, 1.0), spiky_frac=0.4))
# benchmarks/table1_quality.py's fit: 64², 700 Gaussians, aabb; 40 of its
# 150 steps, to keep the whole script well inside its time limit (the
# gate is a falling loss).
TRAIN_FIT = dict(res=64, n=700, seed=7, steps=40,
                 scene_kw=TRAIN_GRADS["scene_kw"])
# tests/test_stream.py's 512² / 65,536-Gaussian stream frame, the largest
# stream configuration of the repo whose autograd tape fits one card; the
# target is the render of a second scene of the same kind.
TRAIN_512 = dict(res=512, n=1 << 16, seed=11, target_seed=12, k_max=1536,
                 steps=5, scene_kw=dict(scale_range=(-3.3, -2.7),
                                        stretch=3.0,
                                        opacity_range=(-1.0, 3.0)))
# Autograd tape of `raster.blend_pass` per (tile pixel, list entry): eleven
# float32 (T, P) tensors (d0, d0², d1, d1², c·d0, exp(-E), o·exp(-E), the
# gated alpha, T, T·alpha, 1 - alpha) and one bool lane mask.
TAPE_BYTES_PER_PIXEL_ENTRY = 45
RESUME_STEPS, RESUME_EVERY = 6, 3


def seeded_scene(cfg: dict, dev, seed=None):
    gen = torch.Generator(device=dev).manual_seed(
        cfg["seed"] if seed is None else seed)
    return random_scene(gen, cfg["n"], **cfg["scene_kw"])


def sinusoid_target(res: int, dev) -> torch.Tensor:
    """benchmarks/train_dataflow.py's target image."""
    r = torch.arange(res, dtype=torch.float32, device=dev) / res
    y, x = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([0.5 + 0.4 * torch.sin(3 * x + 2 * y),
                        0.5 + 0.4 * torch.cos(2 * y),
                        0.5 + 0.4 * torch.sin(4 * x * y)], -1)


def survivor_counts(scene, cam, grid: GridConfig) -> torch.Tensor:
    """(T,) Stage-1 survivor count of every tile, counted one tile chunk at
    a time as `measure_k_max` counts it."""
    g = grid.with_resolution(cam.height, cam.width).make()
    proj = project(scene, cam)
    origins = g.tile_origins(proj.depth.device)
    chunk = tile_chunk(g.num_tiles, scene.n, COMPACT_CHUNK_ELEMS)
    return torch.cat([aabb_mask(proj, origins[s:s + chunk], g.tile).sum(1)
                      for s in range(0, g.num_tiles, chunk)])


def grad_leaves(grads) -> list:
    return [getattr(grads, f) for f in training.SCENE_FIELDS]


def grad_max_rel(got, want) -> float:
    """benchmarks/train_dataflow.py's stream/dense metric: the largest
    |a - b| / (|b| + 1e-8) over every element of every leaf."""
    return max(float(((a - b).abs() / (b.abs() + 1e-8)).max())
               for a, b in zip(grad_leaves(got), grad_leaves(want)))


def grad_excess(got, want, rtol: float, atol: float) -> float:
    """The largest |a - b| / (atol + rtol·|b|): at most 1 where every
    element of every leaf is within the tolerance."""
    return max(float(((a - b).abs() / (atol + rtol * b.abs())).max())
               for a, b in zip(grad_leaves(got), grad_leaves(want)))


def all_finite(grads) -> bool:
    return all(bool(torch.isfinite(g).all()) for g in grad_leaves(grads))


def profiled_grad(plan, scene, cam, target) -> dict:
    """`loss_fn` and its gradient at `scene` once, the forward and the
    backward each under torch.profiler: loss, grads, device-busy ms and
    the top device kernels of each."""
    params = [getattr(scene, f).detach().requires_grad_(True)
              for f in training.SCENE_FIELDS]
    box = {}

    def forward():
        box["loss"] = training.loss_fn(GaussianScene(*params), cam, target,
                                       plan, 0.2)

    def backward():
        box["grads"] = torch.autograd.grad(box["loss"], params)

    fwd_ms, fwd_rows = device_profile(forward)
    bwd_ms, bwd_rows = device_profile(backward)
    return dict(loss=float(box["loss"]), grads=GaussianScene(*box["grads"]),
                fwd_device_ms=fwd_ms, bwd_device_ms=bwd_ms,
                fwd_top=fwd_rows[:5], bwd_top=bwd_rows[:5])


def check_no_launches(label: str) -> None:
    launches = launches_now()
    check(not any(launches.values()),
          f"{label}: training launched kernels {launches}")


def phase_train_grads(cfg: dict, dev) -> dict:
    """9a: the gradient on the card under the stream and the dense
    dataflow (FULL_FP32) and under a SPILL plan of 32 passes of 8 entries
    against its one pass of 256 (MIXED, test_spill.py's pair)."""
    res, n = cfg["res"], cfg["n"]
    scene = seeded_scene(cfg, dev)
    cam = default_camera(res, res, device=dev)
    target = sinusoid_target(res, dev)
    grid = GridConfig(res, res)
    fp32 = RenderPlan(grid=grid, test=TestConfig(precision=FULL_FP32),
                      stream=StreamConfig(k_max=cfg["k_max"]))
    plans = dict(
        stream=fp32, dense=dataclasses.replace(fp32, dataflow="dense"),
        spill=RenderPlan(grid=grid, test=TestConfig(precision=MIXED),
                         stream=StreamConfig(k_max=8, overflow="spill",
                                             max_spill_passes=32)),
        one_pass=RenderPlan(grid=grid, test=TestConfig(precision=MIXED),
                            stream=StreamConfig(k_max=256)))
    longest = int(survivor_counts(scene, cam, grid).max())
    rows = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, plan in plans.items():
            rows[name] = profiled_grad(plan, scene, cam, target)
    spill_warned = sum(issubclass(w.category, StreamOverflowWarning)
                       for w in caught)
    check(all(all_finite(r["grads"]) for r in rows.values()),
          "train 9a: a gradient is not finite")
    rel = grad_max_rel(rows["stream"]["grads"], rows["dense"]["grads"])
    check(rel < 1e-3, f"train 9a: grad(stream) vs grad(dense) max "
          f"relative error {rel} (>= 1e-3)")
    excess = grad_excess(rows["spill"]["grads"], rows["one_pass"]["grads"],
                         1e-5, 1e-7)
    check(excess <= 1.0, f"train 9a: SPILL gradient off its one pass by "
          f"{excess} x (rtol 1e-5, atol 1e-7)")
    check(float(rows["stream"]["grads"].colors.abs().max()) > 0,
          "train 9a: zero colour gradient")
    check_no_launches("train 9a")
    log(f"[train 9a] {res}x{res}, {n} Gaussians, longest survivor list "
        f"{longest} (SPILL capacity 256, overflow warnings {spill_warned}): "
        f"grad(stream) vs grad(dense) max relative error {rel:.2e} "
        f"(bound 1e-3); SPILL 8 x 32 vs one pass of 256, largest "
        f"|Δ| / (1e-7 + 1e-5·|g|) {excess:.3f} (bound 1); device ms "
        "forward/backward " + ", ".join(
            f"{k} {r['fwd_device_ms']:.2f}/{r['bwd_device_ms']:.2f}"
            for k, r in rows.items()))
    for r in rows.values():
        r.pop("grads")
    return dict(longest=longest, grad_max_rel=rel, spill_excess=excess,
                spill_overflow_warnings=spill_warned, plans=rows)


def phase_train_fit(cfg: dict, dev) -> dict:
    """9b: table1_quality.py's fit shape (aabb, FULL_FP32, k_max = n)
    against the sinusoid: `fit` for its steps (phase 9a warmed the same
    kernels), ms a step, PSNR before and after, the device-busy share of
    one step."""
    res, steps = cfg["res"], cfg["steps"]
    scene0 = seeded_scene(cfg, dev)
    cam = default_camera(res, res, device=dev)
    target = sinusoid_target(res, dev)
    plan = RenderConfig(height=res, width=res, method="aabb",
                        precision=FULL_FP32, k_max=cfg["n"]).to_plan()
    tc = training.TrainConfig()
    (scene, losses), wall = sync_wall_ms(
        lambda: training.fit(scene0, cam, target, plan, tc, steps=steps))
    step_ms = wall / steps
    check(losses.shape == (steps,) and bool(torch.isfinite(losses).all()),
          f"train 9b: losses {losses.shape}, finite "
          f"{bool(torch.isfinite(losses).all())}")
    check(float(losses[-1]) < float(losses[0]),
          f"train 9b: loss {float(losses[0])} -> {float(losses[-1])} did "
          "not fall")
    busy, top = device_profile(lambda: training.train_step(
        training.init_state(scene), cam, target, plan, tc))
    with torch.no_grad():
        before = float(psnr(plan.render(scene0, cam).image, target))
        after = float(psnr(plan.render(scene, cam).image, target))
    check_no_launches("train 9b")
    log(f"[train 9b] fit {res}x{res}, {cfg['n']} Gaussians, aabb, "
        f"{steps} steps: loss {float(losses[0]):.4f} -> "
        f"{float(losses[-1]):.4f}, PSNR {before:.2f} -> {after:.2f} dB; "
        f"{step_ms:.1f} ms a step (synchronized, {wall / 1e3:.1f} s in "
        f"all); one step's device busy {busy:.1f} ms "
        f"({100 * busy / step_ms:.1f}% of a step); top device time: "
        + "; ".join(f"{k[:48]} {v:.2f} ms" for k, v in top[:3]))
    return dict(loss_first=float(losses[0]), loss_last=float(losses[-1]),
                psnr_before=before, psnr_after=after, step_ms=step_ms,
                wall_s=wall / 1e3, step_device_busy_ms=busy,
                busy_share=busy / step_ms, top_device_ms=top[:5])


def phase_train_512(cfg: dict, dev) -> dict:
    """9c: 5 Adam steps at the card's size (MIXED, SMOOTH_FOCUSED CAT),
    fitting the render of a second seeded scene: per step wall, loss and
    finite share of the gradient; the peak memory against the tape's
    reckoning; one forward and backward under torch.profiler."""
    res, k_max = cfg["res"], cfg["k_max"]
    scene0 = seeded_scene(cfg, dev)
    hidden = seeded_scene(cfg, dev, seed=cfg["target_seed"])
    cam = default_camera(res, res, device=dev)
    grid = GridConfig(res, res)
    counts = torch.maximum(survivor_counts(scene0, cam, grid),
                           survivor_counts(hidden, cam, grid))
    longest = int(counts.max())
    overflow_tiles = int((counts > k_max).sum())
    stream = (StreamConfig(k_max=k_max) if not overflow_tiles else
              StreamConfig(k_max=k_max, overflow="spill",
                           max_spill_passes=next_pow2(-(-longest // k_max))))
    plan = RenderPlan(grid=grid, test=TestConfig(precision=MIXED),
                      stream=stream)
    with torch.no_grad():
        target = plan.render(hidden, cam).image
    del hidden
    g = grid.make()
    tape = (TAPE_BYTES_PER_PIXEL_ENTRY * g.num_tiles * g.tile ** 2 * k_max
            * plan.n_passes)
    tc = training.TrainConfig()
    state = training.init_state(scene0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for step in range(1, cfg["steps"] + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = training.value_and_grad(state.scene, cam, target, plan,
                                              tc.ssim_weight)
        leaves = grad_leaves(grads)
        finite = (sum(int(torch.isfinite(x).sum()) for x in leaves)
                  / sum(x.numel() for x in leaves))
        state = training.adam_update(state, grads, tc)
        torch.cuda.synchronize()
        rows.append(dict(step=step, wall_ms=(time.perf_counter() - t0) * 1e3,
                         loss=float(loss), finite_share=finite))
        del grads, leaves
        log(f"[train 9c] step {step}: wall {rows[-1]['wall_ms']:.0f} ms, "
            f"loss {rows[-1]['loss']:.5f}, finite gradient share "
            f"{finite:.6f}")
    peak = torch.cuda.max_memory_allocated()
    prof = profiled_grad(plan, state.scene, cam, target)
    prof.pop("grads")
    check(prof["loss"] < rows[0]["loss"],
          f"train 9c: loss {rows[0]['loss']} -> {prof['loss']} after "
          f"{cfg['steps']} steps did not fall")
    check_no_launches("train 9c")
    walls = [r["wall_ms"] for r in rows]
    log(f"[train 9c] {res}x{res}, {cfg['n']} Gaussians, MIXED CAT, k_max "
        f"{k_max}: longest survivor list {longest}, {overflow_tiles} tiles "
        f"over k_max -> {stream.overflow.value} ({plan.n_passes} "
        f"pass{'es' if plan.n_passes > 1 else ''}); loss "
        f"{rows[0]['loss']:.5f} -> {prof['loss']:.5f} after "
        f"{cfg['steps']} steps; ms a step {min(walls):.0f}-{max(walls):.0f} "
        f"(mean of steps 2-{cfg['steps']} "
        f"{sum(walls[1:]) / max(len(walls) - 1, 1):.0f}); profiled "
        f"forward {prof['fwd_device_ms']:.1f} device ms, backward "
        f"{prof['bwd_device_ms']:.1f} device ms; peak memory "
        f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB over the "
        f"{base / 1e9:.2f} GB held before) against the tape's reckoning "
        f"{tape / 1e9:.2f} GB ({TAPE_BYTES_PER_PIXEL_ENTRY} B a pixel-entry)")
    for label in ("fwd", "bwd"):
        log(f"[train 9c] top 5 device kernels, {label}: " + "; ".join(
            f"{k[:60]} {v:.1f} ms" for k, v in prof[f"{label}_top"]))
    trained = GaussianScene(*(getattr(state.scene, f).detach()
                              for f in training.SCENE_FIELDS))
    return dict(longest=longest, overflow_tiles=overflow_tiles,
                policy=stream.overflow.value, passes=plan.n_passes,
                steps=rows, loss_after=prof["loss"],
                fwd_device_ms=prof["fwd_device_ms"],
                bwd_device_ms=prof["bwd_device_ms"],
                fwd_top=prof["fwd_top"], bwd_top=prof["bwd_top"],
                peak_bytes=peak, base_bytes=base, tape_reckoning_bytes=tape,
                trained=trained, plan=plan, cam=cam)


def phase_train_serve(trained, plan, cam) -> dict:
    """9d: the trained scene through the serving plan (K1 and K2), held
    within 2e-4 of the all-"torch" plan's frame, K1 and K2 once a pass."""
    served = dataclasses.replace(
        plan, test=dataclasses.replace(plan.test, backend="cuda"),
        raster=RasterConfig(fused=True))
    with torch.no_grad():
        want, plain_ms = sync_wall_ms(lambda: plan.render(trained, cam))
        reset_launches()
        got, ms = sync_wall_ms(lambda: served.render(trained, cam))
        launches = check_launches("train 9d", served.n_passes)
        err = held_to_plain(got, want, "train 9d")
    log(f"[train 9d] trained scene served through K1 and K2: max |Δ| "
        f"{err:.2e} against the all-\"torch\" frame (bound 2e-4); launches "
        f"{launches} for {served.n_passes} pass(es); frame {ms:.1f} ms "
        f"(all-\"torch\" {plain_ms:.1f} ms)")
    return dict(max_abs_err=err, launches=launches, passes=served.n_passes,
                frame_ms=ms, plain_frame_ms=plain_ms)


def phase_train_resume(cfg: dict, dev) -> dict:
    """9e: `fit` under a FaultManager (save_every 3) for 6 steps of 9a's
    fit, then a second run that holds only the step-3 checkpoint resumed
    to step 6, under deterministic algorithms: bit-equal to the
    uninterrupted run (scene, moments, step and the losses of steps 4-6).
    The checkpoints go under build/train_ckpt and are removed after."""
    res = cfg["res"]
    scene = seeded_scene(cfg, dev)
    cam = default_camera(res, res, device=dev)
    target = sinusoid_target(res, dev)
    plan = RenderPlan(grid=GridConfig(res, res),
                      test=TestConfig(precision=FULL_FP32),
                      stream=StreamConfig(k_max=cfg["k_max"]))
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def manager(name):
        return FaultManager(FaultConfig(
            ckpt_dir=os.path.join(root, name), save_every=RESUME_EVERY,
            install_sigterm_hook=False))

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            full = manager("full")
            (want, want_losses), full_ms = sync_wall_ms(lambda: training.fit(
                scene, cam, target, plan, steps=RESUME_STEPS, fault=full))
            saved = sorted(os.listdir(full.cfg.ckpt_dir))
            resumed = manager("resumed")
            step3 = f"step_{RESUME_EVERY:08d}"
            shutil.copytree(os.path.join(full.cfg.ckpt_dir, step3),
                            os.path.join(resumed.cfg.ckpt_dir, step3))
            (got, losses), resume_ms = sync_wall_ms(lambda: training.fit(
                scene, cam, target, plan, steps=RESUME_STEPS,
                fault=resumed))
            like = training.init_state(scene)
            a = ckpt.restore(full.cfg.ckpt_dir, RESUME_STEPS, like)
            b = ckpt.restore(resumed.cfg.ckpt_dir, RESUME_STEPS, like)
        nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(root, ignore_errors=True)
    check(saved == [f"step_{s:08d}" for s in (3, 6)],
          f"train 9e: checkpoints {saved}")
    same = [torch.equal(x, y) for x, y in zip(ckpt.flatten(a),
                                               ckpt.flatten(b))]
    same_scene = all(torch.equal(getattr(got, f), getattr(want, f))
                     for f in training.SCENE_FIELDS)
    same_losses = torch.equal(losses, want_losses[RESUME_EVERY:])
    diff = max(float((x - y).abs().max()) for x, y in
               zip(ckpt.flatten(a), ckpt.flatten(b)))
    log(f"[train 9e] fit {RESUME_STEPS} steps under a FaultManager (saved "
        f"{saved}), resumed from step {RESUME_EVERY} to "
        f"{RESUME_STEPS}, deterministic algorithms: state bit-equal "
        f"{all(same)} ({sum(same)}/{len(same)} leaves, max |Δ| {diff:.2e}), "
        f"scene {same_scene}, losses of steps 4-6 {same_losses}; "
        f"nondeterministic-op warnings {nondet or 'none'}; walls "
        f"{full_ms:.0f} ms (6 steps) and {resume_ms:.0f} ms (3 steps); "
        f"build/train_ckpt removed {not os.path.exists(root)}")
    check(all(same) and same_scene and same_losses,
          "train 9e: the resumed fit differs from the uninterrupted one")
    check(int(a.step) == RESUME_STEPS, f"train 9e: step {int(a.step)}")
    return dict(saved=saved, bit_equal=True, max_abs_diff=diff,
                nondeterministic_warnings=nondet, full_ms=full_ms,
                resume_ms=resume_ms)


def phase_train(dev=torch.device("cuda"), grads_cfg: dict = TRAIN_GRADS,
                fit_cfg: dict = TRAIN_FIT, big_cfg: dict = TRAIN_512) -> dict:
    """Phase 9: 9a gradient parity, 9b the reference's fit, 9c training at
    512² / 65,536 Gaussians, 9d the trained scene served through K1 and
    K2, 9e checkpoint and resume. 9a-9c launch no kernel."""
    reset_launches()
    grads = timed_phase("train 9a", phase_train_grads, grads_cfg, dev)
    fit = timed_phase("train 9b", phase_train_fit, fit_cfg, dev)
    big = timed_phase("train 9c", phase_train_512, big_cfg, dev)
    torch.cuda.empty_cache()
    served = timed_phase("train 9d", phase_train_serve, big.pop("trained"),
                         big.pop("plan"), big.pop("cam"))
    resume = timed_phase("train 9e", phase_train_resume, grads_cfg, dev)
    return dict(grads=grads, fit=fit, train512=big, serve=served,
                resume=resume)


# ---------------------------------------------------------------------------
# Phase 10: the serving driver (launch/serve.py), render and LM modes
# ---------------------------------------------------------------------------

# The demo scenes probe to k_max 8192 at 1024²; a batch of 4 folds 16,384
# tiles, and 16384 x 8192 x 16 mini-tiles reach K1's int32 index (2**31),
# so K1's wrapper launches such a fold in two row ranges
# (`prtu.entry_row_ranges`).
DRIVER_RENDER = ["--mode", "render", "--device", "cuda", "--frames", "8",
                 "--res", "1024", "--gaussians", "131072", "--max-batch",
                 "4", "--pallas"]
DRIVER_LM = ["--mode", "lm", "--device", "cuda", "--arch", "qwen1.5-0.5b",
             "--batch", "4", "--prefill", "512", "--decode", "64"]
LM_SELF_TOKENS = 64              # 10c: teacher-forced positions, batch 1
LM_SELF_SEED = 10
CARD_CPU_PROMPT, CARD_CPU_DECODE = 20, 8
SPLIT_ROWS = 256                 # 10a: K1 rows held either side of a split


def driver_dispatches(engine, results) -> dict:
    """The driver's dispatches, one per (scene, resolution, batch wall):
    {key: dict(passes, bucket, ranges, requests)}, `ranges` the K1 row
    ranges of one pass of the dispatch's fold of `bucket` frames."""
    out = {}
    for r in results:
        req = r.frame.request
        cam = req.camera
        key = (req.scene, cam.height, cam.width, r.render_s)
        if key not in out:
            k = engine.plan_for(req.scene, cam.height, cam.width).stream.k_max
            tiles = (cam.height // 16) * (cam.width // 16)
            out[key] = dict(passes=r.frame.passes_run,
                            bucket=r.frame.bucket_size,
                            ranges=prtu.entry_row_ranges(
                                r.frame.bucket_size * tiles, k),
                            requests=[])
        out[key]["requests"].append(req)
    return out


def driver_fold_split(engine, dispatch: dict) -> dict:
    """K1 on pass 0 of a dispatch whose fold K1's wrapper splits: launched
    once a row range, and equal to its plain version on the SPLIT_ROWS tile
    rows either side of each split (the plain version over the whole fold's
    mask would need tens of GB)."""
    reqs = dispatch["requests"]
    name, cam0 = reqs[0].scene, reqs[0].camera
    plan = engine.plan_for(name, cam0.height, cam0.width)
    cams = [r.camera.to(engine.device) for r in reqs]
    cams += [cams[-1]] * (dispatch["bucket"] - len(cams))
    pss = [plan.preprocess(engine.scene(name), c) for c in cams]
    tss = [plan.stage1_compact(ps)[0] for ps in pss]
    fold = fold_frames([ps.proj for ps in pss], pss[0].grid)
    kw = prec_kw(plan.test.precision)
    cat_ops = ops.entry_cat_operands(
        fold.proj, pss[0].grid, fold.ids([t.lists for t in tss]),
        fold.cat([t.valid for t in tss]), tile_origins=fold.tile_origins)
    del pss, tss
    before = prtu.launches
    got = prtu.prtu_entry_cat_mask(*cat_ops, **kw)
    torch.cuda.synchronize()
    launched = prtu.launches - before
    ranges = prtu.entry_row_ranges(*cat_ops[5].shape)
    check(launched == len(ranges) == len(dispatch["ranges"]) > 1,
          f"serve 10a: K1 launched {launched} times on a fold of "
          f"{len(ranges)} row ranges")
    flips = held = 0
    for _, t1 in ranges[:-1]:
        rows = slice(t1 - SPLIT_ROWS, t1 + SPLIT_ROWS)
        want = prtu.prtu_entry_cat_mask_plain(
            cat_ops[0], cat_ops[1], *(x[rows] for x in cat_ops[2:]), **kw)
        flips += int((got[rows] != want).sum())
        held += want.numel()
    check(flips == 0, f"serve 10a: K1 on the rows either side of the split: "
          f"{flips} flips")
    log(f"[serve 10a] K1 on a fold of {len(cams)} frames "
        f"({cat_ops[5].shape[0]} tiles x {cat_ops[5].shape[1]} entries): "
        f"{launched} launches over row ranges {ranges}; 0 flips against its "
        f"plain version on the {2 * SPLIT_ROWS} rows around each split "
        f"({held} mini-tile tests)")
    return dict(tiles=cat_ops[5].shape[0], k=cat_ops[5].shape[1],
                ranges=ranges, launches=launched, flips=flips,
                tests_held=held)


def phase_driver_render(argv: list = DRIVER_RENDER) -> dict:
    """10a: the render driver on the card, held to the plain render."""
    args = serve_driver.parser().parse_args(argv)
    reset_launches()
    out = serve_driver.run_render(args, log=lambda m: log(f"[serve 10a] {m}"))
    launches = launches_now()
    engine, results = out["engine"], out["results"]
    # Each dispatch ran K1 once a row range of each pass and the unfused
    # blend, so no K2.
    dispatches = driver_dispatches(engine, results)
    passes = sum(d["passes"] for d in dispatches.values())
    expected = sum(d["passes"] * len(d["ranges"])
                   for d in dispatches.values())
    check(launches["prtu_entry_cat_mask"] == expected,
          f"serve 10a: K1 launched {launches['prtu_entry_cat_mask']} times "
          f"for {passes} dispatch passes of {expected} row ranges")
    check(passes > 0, "serve 10a: K1 never launched")
    check(launches["blend_tiles_fused"] == 0,
          "serve 10a: K2 launched on the driver's unfused path")
    errs = []
    for i, r in enumerate(results):
        req = r.frame.request
        check(bool(torch.isfinite(r.image).all()), "serve 10a: non-finite")
        want = plain_render(engine, req.scene, req.camera)
        errs.append(held_to_plain(r.frame, want, f"serve 10a request {i}"))
    snapshot = engine.telemetry.snapshot()
    log(f"[serve 10a] {engine.telemetry.format_snapshot()}")
    k_max = {n: engine._scenes[n].k_max for n in engine.scene_names()}
    log(f"[serve 10a] {len(results)} frames in {len(dispatches)} dispatches "
        f"(max_batch {args.max_batch}; buckets "
        f"{[d['bucket'] for d in dispatches.values()]}, K1 row ranges a "
        f"pass {[len(d['ranges']) for d in dispatches.values()]}), scene "
        f"k_max {k_max}; launches {launches} for {passes} passes; max |Δ| "
        f"against the plain render {max(errs):.2e} (bound 2e-4); waves ms "
        f"{[round(w['ms'], 1) for w in out['waves']]}")
    split = [d for d in dispatches.values() if len(d["ranges"]) > 1]
    check(bool(split), "serve 10a: no dispatch folded past K1's int32 "
          "index")
    fold = driver_fold_split(engine, split[0])
    return dict(frames=len(results), dispatches=len(dispatches),
                passes=passes, launches=launches, max_batch=args.max_batch,
                buckets=[d["bucket"] for d in dispatches.values()],
                row_ranges=[len(d["ranges"]) for d in dispatches.values()],
                k_max=k_max, max_abs_err=max(errs), waves=out["waves"],
                fold_split=fold,
                telemetry={k: v for k, v in snapshot.items()
                           if isinstance(v, (int, float))})


def cache_bytes(caches) -> int:
    kv = caches["kv"]
    return nbytes(*kv["kv"], *kv.get("scale", ()))


def logits_agree(got, want, label: str, rms_max=0.05, agree_min=0.9):
    """Relative RMS and argmax agreement of two logit sets, checked
    against the reference's own gates (`tests/test_kv_quant.py`)."""
    got, want = got.float(), want.float()
    rms = float(torch.sqrt(((got - want) ** 2).mean())
                / torch.sqrt((want ** 2).mean()))
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    check(rms <= rms_max and agree >= agree_min,
          f"{label}: relative RMS {rms:.4f} (<= {rms_max}), argmax "
          f"agreement {agree:.3f} (>= {agree_min})")
    return dict(rel_rms=rms, agreement=agree)


def decode_tokens(model, tokens, caches=None) -> tuple:
    """Teacher-forced decode of `tokens` (B, S) from `caches`, by default
    fresh caches of length S: (logits (B, S, V), caches)."""
    b, s = tokens.shape
    caches = model.init_caches(b, s) if caches is None else caches
    outs = []
    for i in range(s):
        lg, caches = model.decode_step(caches, tokens[:, i:i + 1])
        outs.append(lg)
    return torch.stack(outs, 1), caches


def decode_step_bytes(model, caches, batch: int) -> int:
    """Bytes one decode step at the caches' `pos` must move: every weight read
    once (an untied input table only for the batch's rows; the MoE's
    dispatch runs every expert, so every expert's weights; not the enc-dec's
    encoder, which only its prefill runs), the live positions 0..pos of
    each attention or latent cache read, the enc-dec's encoder output read
    whole, and each SSM state and conv tail read and written."""
    p = model.compute_params()
    pos = caches["pos"]
    n = batch * model.cfg.d_model * p["embed"]["tok"].element_size()
    for path, t in leaves(p):
        if path == "embed.tok" and not model.cfg.tie_embeddings:
            continue
        if path.startswith("encoder.") or path == "ln_enc":
            continue
        n += nbytes(t)
    for key, val in caches.items():
        if key == "pos":
            continue
        tensors = (val["kv"] + val.get("scale", ())
                   if isinstance(val, dict) else
                   val if isinstance(val, tuple) else (val,))
        for t in tensors:
            if key in ("ssm", "groups", "tail"):
                n += 2 * nbytes(t)
            elif key == "enc_out":
                n += nbytes(t)
            else:                          # (L, B, S, ...): live positions
                n += nbytes(t) * (pos + 1) // t.shape[2]
    return n


def lm_serve(args, model, tag: str) -> dict:
    """The LM driver's run (`serve.run_lm`) on `model`, then its warm
    prefill, five warm decode steps and one profiled step: prefill ms
    (first and warm), decode ms a token (median and p90 after the first
    step), tokens/s, peak memory, the warm step's device-busy ms and top
    kernels against its wall, and the step's byte bound."""
    cfg = model.cfg
    param_bytes = nbytes(*model.state_dict().values())
    out = serve_driver.run_lm(args, model,
                              log=lambda m: log(f"[{tag}] {m}"))
    finite = bool(torch.isfinite(out["prefill_logits"].float()).all()) and \
        all(bool(torch.isfinite(x.float()).all()) for x in out["step_logits"])
    check(finite, f"{tag}: non-finite logits")
    steps = sorted(out["step_ms"][1:])
    median = steps[len(steps) // 2]
    p90 = steps[min(len(steps) - 1, int(0.9 * len(steps)))]
    batch = serve_driver.lm_batch(cfg, args.batch, args.prefill,
                                  model.device)
    _, warm_prefill = sync_wall_ms(lambda: model.prefill(batch))
    caches = model.init_caches(args.batch, args.prefill + args.decode)
    tok = torch.ones((args.batch, 1), dtype=torch.long, device=model.device)
    walls = []
    for _ in range(5):
        (_, caches), ms = sync_wall_ms(lambda: model.decode_step(caches, tok))
        walls.append(ms)
    step_wall = sorted(walls)[2]
    step_bytes = decode_step_bytes(model, caches, args.batch)
    busy, top = device_profile(lambda: model.decode_step(caches, tok))
    peak = torch.cuda.max_memory_allocated()
    res = dict(arch=cfg.name, batch=args.batch, prefill=args.prefill,
               decode=args.decode, param_bytes=param_bytes,
               param_count=cfg.param_count(),
               params=sum(p.numel() for p in model.parameters()),
               prefill_ms=out["prefill_ms"], warm_prefill_ms=warm_prefill,
               first_step_ms=out["step_ms"][0], decode_median_ms=median,
               decode_p90_ms=p90,
               tokens_per_s=args.batch / (median / 1e3),
               prefill_tokens_per_s=args.batch * args.prefill
               / (warm_prefill / 1e3),
               step_wall_ms=step_wall, step_busy_ms=busy,
               step_busy_share=busy / step_wall, top_kernels=top[:5],
               step_bytes=step_bytes,
               step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
               peak_bytes=peak)
    log(f"[{tag}] {cfg.name} full width ({res['params']} parameters, "
        f"{param_bytes / 1e9:.3f} GB of {cfg.param_dtype} weights; "
        f"param_count() {res['param_count']}): prefill "
        f"{args.batch}x{args.prefill} {out['prefill_ms']:.1f} ms first, "
        f"{warm_prefill:.1f} ms warm ({res['prefill_tokens_per_s']:.0f} "
        f"tokens/s); decode {median:.2f} ms/token median, {p90:.2f} p90 "
        f"(first step {res['first_step_ms']:.1f}), "
        f"{res['tokens_per_s']:.0f} tokens/s at batch {args.batch}; one "
        f"warm step {step_wall:.2f} ms wall, {busy:.2f} ms device-busy "
        f"({100 * busy / step_wall:.1f}%), byte bound "
        f"{res['step_bound_ms']:.3f} ms ({step_bytes / 1e9:.3f} GB); top "
        f"kernels {[(k, round(v, 3)) for k, v in top[:5]]}; peak "
        f"{peak / 1e9:.2f} GB; logits finite")
    return res


def phase_driver_lm(argv: list = DRIVER_LM) -> dict:
    """10b: the LM driver at full width."""
    args = serve_driver.parser().parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = sync_wall_ms(lambda: serve_driver.lm_model(args))
    res = lm_serve(args, model, "serve 10b")
    log(f"[serve 10b] weights drawn in {init_ms:.0f} ms")
    return dict(res, init_ms=init_ms, model=model)


def self_consistency(model, toks, label: str, gate: bool) -> dict:
    """Teacher-forced decode of `toks` against `forward`, and the int8
    cache against the bf16 one over the same tokens; checked against the
    reference's gates when `gate`, else only measured."""
    cfg = model.cfg
    (full, _), fwd_ms = sync_wall_ms(lambda: model.forward(dict(tokens=toks)))
    (dec, caches), dec_ms = sync_wall_ms(lambda: decode_tokens(model, toks))
    quant = Model(dataclasses.replace(cfg, kv_quant=True), device="meta")
    quant.load_state_dict(model.state_dict(), assign=True)
    (dec8, caches8), dec8_ms = sync_wall_ms(lambda: decode_tokens(quant,
                                                                  toks))
    limits = (0.05, 0.9) if gate else (math.inf, 0.0)
    vs_forward = logits_agree(dec, full, f"serve 10c {label} decode vs "
                              "forward", *limits)
    vs_bf16 = logits_agree(dec8, dec, f"serve 10c {label} int8 vs bf16 "
                           "cache", *limits)
    ratio = cache_bytes(caches8) / cache_bytes(caches)
    check(ratio <= 0.55, f"serve 10c: int8 cache {ratio:.3f} of bf16's")
    log(f"[serve 10c] {label}{'' if gate else ' (measured, not gated)'}: "
        f"{toks.shape[1]} teacher-forced steps vs forward: relative RMS "
        f"{vs_forward['rel_rms']:.4f}, agreement "
        f"{vs_forward['agreement']:.3f}; int8 cache vs bf16: relative RMS "
        f"{vs_bf16['rel_rms']:.4f}, agreement {vs_bf16['agreement']:.3f}"
        f"{' (gates 0.05, 0.9)' if gate else ''}; cache bytes "
        f"{cache_bytes(caches8)} vs {cache_bytes(caches)} ({ratio:.3f}, <= "
        f"0.55); forward {fwd_ms:.1f} ms, decode {dec_ms:.0f} ms (bf16) / "
        f"{dec8_ms:.0f} ms (int8) for {toks.shape[1]} steps")
    return dict(vs_forward=vs_forward, int8_vs_bf16=vs_bf16,
                cache_ratio=ratio, forward_ms=fwd_ms, decode_ms=dec_ms,
                decode_int8_ms=dec8_ms)


ATTN_IN_PROJ = ("wq", "wk", "wv", "w_q", "w_uk", "w_uv")


def fan_in_attention(model) -> int:
    """Rescale every attention projection in place to the contraction
    dimension's fan-in, where the reference's init (and so the driver's)
    takes the second-to-last dimension: the input projections (..., in,
    heads, hd) of self- and cross-attention (wq, wk, wv) and of MLA (w_q,
    and w_uk, w_uv from the latent) by (heads / in) ** 0.5, and every
    attention's output projection wo (..., heads, hd, d) by heads ** -0.5.
    Returns how many tensors it rescaled."""
    n = 0
    with torch.no_grad():
        for name, w in model.named_parameters():
            *parents, leaf = name.split(".")
            if not parents or parents[-1] not in ("attn", "xattn"):
                continue
            if leaf in ATTN_IN_PROJ:
                w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
            elif leaf == "wo":
                w.mul_(w.shape[-3] ** -0.5)
            else:
                continue
            n += 1
    return n


def phase_lm_self(model) -> dict:
    """10c at full width. With the driver's weights (the reference's init:
    the attention projections' fan-in is taken over the heads, so q and k
    come out ~8x too large and the attention logits have a std of ~60)
    the network amplifies any rounding difference several-fold a layer,
    so decode against forward is measured and printed, not gated. The
    reference's gates then hold on the same weights with the attention
    projections at the contraction dimension's fan-in."""
    gen = torch.Generator(device="cpu").manual_seed(LM_SELF_SEED)
    toks = torch.randint(0, model.cfg.vocab_size, (1, LM_SELF_TOKENS),
                         generator=gen).to(model.device)
    seed0 = self_consistency(model, toks, "seed-0 weights", gate=False)
    fan_in_attention(model)
    gated = self_consistency(model, toks, "fan-in attention", gate=True)
    return dict(seed0=seed0, fan_in=gated)


def card_vs_cpu_logits(dev) -> dict:
    """Reduced qwen1.5-0.5b under float32 compute: the same weights on `dev`
    and on the CPU through `models.parity.lm_parity` (forward, prefill, 8
    teacher-forced decode steps under float32 caches at rtol 1e-4 and atol
    1e-4 x max|logit|; under the model's bf16 caches each cache element
    within one bf16 ulp, their logits reported). Returns {label: error}."""
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")),
                              dtype="float32", attn_chunk=8)
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    gen = torch.Generator(device="cpu").manual_seed(LM_SELF_SEED)
    prompt = torch.randint(0, cfg.vocab_size, (2, CARD_CPU_PROMPT),
                           generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, CARD_CPU_DECODE),
                         generator=gen)
    result = parity.lm_parity(card, cpu, prompt, toks, dev, "cpu")
    check(not parity.failures(result), f"card vs CPU: {result}")
    return {k: e for k, (e, _) in result.items()}


def phase_lm_card_vs_cpu() -> dict:
    """10d: the card against the CPU on the same weights."""
    out = card_vs_cpu_logits(torch.device("cuda"))
    log(f"[serve 10d] reduced qwen1.5-0.5b, float32: max |Δ| / max|logit| "
        f"card vs CPU forward {out['forward']:.2e}, prefill "
        f"{out['prefill']:.2e}, 8 decode steps under float32 caches "
        f"{out['decode_f32_cache']:.2e} (bound rtol 1e-4, atol 1e-4 x "
        f"max|logit|); under bf16 caches {out['decode_model_cache']:.2e} "
        f"(reported), cache elements within {out['caches']:.0f} bf16 ulp "
        "(bound 1)")
    return out


def phase_driver() -> dict:
    """Phase 10: 10a-10d."""
    render_ = timed_phase("serve 10a", phase_driver_render)
    torch.cuda.empty_cache()
    lm = timed_phase("serve 10b", phase_driver_lm)
    model = lm.pop("model")
    self_ = timed_phase("serve 10c", phase_lm_self, model)
    del model
    torch.cuda.empty_cache()
    card = timed_phase("serve 10d", phase_lm_card_vs_cpu)
    return dict(render=render_, lm=lm, self_consistency=self_,
                card_vs_cpu=card)


# ---------------------------------------------------------------------------
# Phase 11: LM serving for the MoE/MLA, SSM, hybrid and enc-dec families
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("deepseek-v2-lite-16b", "mamba2-780m", "zamba2-1.2b",
                "seamless-m4t-large-v2")
FAMILY_TRAFFIC = ["--mode", "lm", "--device", "cuda", "--batch", "4",
                  "--prefill", "512", "--decode", "64"]
# deepseek's float32 master weights and their bf16 compute copy (94 GB) do
# not fit one card: the driver's --param-dtype bfloat16 (the reference's
# own field param_dtype, arctic-480b's setting) holds them in bf16, 31.4
# GB, with no copy.
FAMILY_FLAGS = {"deepseek-v2-lite-16b": ["--param-dtype", "bfloat16"]}
FAMILY_SELF_SEED = 11
# 11e's logit gate at full width: the enc-dec at its full depth, the others
# cut to the depth where the reference's own decode against forward stays
# well inside relative RMS 0.05 (`python tests/test_torch_lm_families.py
# --depth-sweep` on the CPU: the reference and the port grow alike with
# depth and part past 0.05 a few layers further on).
FAMILY_GATE_DEPTH = {"deepseek-v2-lite-16b": 2, "mamba2-780m": 2,
                     "zamba2-1.2b": 2}
LAYER_RMS_MAX = 0.03                 # 11e layerwise (measured <= 0.0223)
CARD_CPU_FAMILIES = ("arctic-480b",) + FAMILY_ARCHS
# 11f: a float32 decode that reads back bf16 state it wrote (an SSM state,
# the enc-dec's encoder output) carries an f32 ulp that flips a bf16
# rounding into later steps; such decodes are held within max |d| 3e-3 x
# max|logit| and relative RMS 1.5e-3, as tests/test_torch_lm_families.py
# holds them against the reference (about twice the worst measured, on the
# card and on the CPU).
BF16_STATE_FAMILIES = ("ssm", "hybrid", "encdec")


def twin(model, **changes):
    """`model`'s weights (shared, not copied) under its config with
    `changes`."""
    m = Model(dataclasses.replace(model.cfg, **changes), device="meta")
    m.load_state_dict(model.state_dict(), assign=True)
    return m


def family_batch(cfg, prompt, gen, device) -> dict:
    """The teacher-forced checks' batch: `prompt`'s tokens, and for the
    enc-dec seeded bf16 encoder frames of the prompt's length."""
    batch = dict(tokens=prompt.to(device))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(
            prompt.shape + (cfg.d_model,), generator=gen).bfloat16().to(
            device)
    return batch


def decode_caches(model, batch, b: int, s: int) -> dict:
    """Fresh caches of length s; the enc-dec's carry the batch's encoder
    output (its prefill's), as a served decode after that prefill would."""
    caches = model.init_caches(b, s)
    if model.cfg.family == "encdec":
        caches["enc_out"] = model.prefill(batch)[1]["enc_out"].to(
            torch.bfloat16)
    return caches


class RoutingLog:
    """Within `with`, every `moe_apply` call's top-k expert ids, sorted,
    in call order (`models.moe.top_k` wrapped)."""

    def __enter__(self):
        self.calls, self._orig = [], moe_mod.top_k

        def top_k(x, k):
            vals, idx = self._orig(x, k)
            self.calls.append(idx.sort(-1).values.cpu())
            return vals, idx
        moe_mod.top_k = top_k
        return self

    def __exit__(self, *exc):
        moe_mod.top_k = self._orig


def routing_flips(fwd_calls: list, dec_calls: list) -> float:
    """The share of (token, MoE layer) whose expert set differs between a
    forward over S tokens (one call a layer, (S, k)) and S one-token
    decode steps (one call a layer a step, (1, k))."""
    fwd = torch.stack(fwd_calls, 1)                       # (S, L, k)
    dec = torch.stack(dec_calls).reshape(fwd.shape[0], len(fwd_calls), -1)
    return float((fwd != dec).any(-1).float().mean())


# The decoder-side blocks `forward` runs, and those `decode_step` runs, in
# the same layer order for every family (`models.blocks`, and the enc-dec
# decoder layer in `models.model`).
FORWARD_BLOCKS = ((blocks_mod, "dense_block"), (blocks_mod, "dense_ffn_block"),
                  (blocks_mod, "moe_block"), (blocks_mod, "ssm_block"),
                  (model_mod, "decoder_block"))
DECODE_BLOCKS = ((blocks_mod, "dense_decode_block"),
                 (blocks_mod, "moe_decode_block"),
                 (blocks_mod, "ssm_decode_block"),
                 (model_mod, "decoder_decode_block"))


class LayerTape:
    """11e's layerwise check. Within `forward()`, each decoder layer of a
    forward keeps its input and output; within `decode()`, each decode
    step's layer l runs on the forward's input to layer l at that position
    (its own cache updated as usual) and keeps what it adds. So every
    layer's decode is compared with its forward on the same input, and a
    rounding difference in one layer does not reach the next."""

    def __init__(self):
        self.fwd, self.dec = [], []

    @staticmethod
    def _patched(targets, wrap):
        origs = [(mod, name, getattr(mod, name)) for mod, name in targets]
        for mod, name, fn in origs:
            setattr(mod, name, wrap(fn))
        return origs

    @staticmethod
    def _restore(origs):
        for mod, name, fn in origs:
            setattr(mod, name, fn)

    def forward(self, model, batch):
        def wrap(fn):
            def block(p, x, *args, **kw):
                out = fn(p, x, *args, **kw)
                self.fwd.append((x, out[0]))
                return out
            return block
        origs = self._patched(FORWARD_BLOCKS, wrap)
        try:
            return model.forward(batch)
        finally:
            self._restore(origs)

    def decode(self, model, toks, caches):
        n = len(self.fwd)

        def wrap(fn):
            def block(p, x, *args, **kw):
                i = len(self.dec)
                x_in = self.fwd[i % n][0][:, i // n:i // n + 1]
                out = fn(p, x_in, *args, **kw)
                self.dec.append(out[0] - x_in)
                return out
            return block
        origs = self._patched(DECODE_BLOCKS, wrap)
        try:
            return decode_tokens(model, toks, caches)
        finally:
            self._restore(origs)

    def layer_rms(self) -> list:
        """Per layer, the relative RMS of what decode adds against what
        the forward adds, over every position."""
        n, out = len(self.fwd), []
        for layer, (x_in, x_out) in enumerate(self.fwd):
            want = (x_out - x_in).float()
            got = torch.cat(self.dec[layer::n], 1).float()
            out.append(float(torch.sqrt(((got - want) ** 2).mean())
                             / torch.sqrt((want ** 2).mean())))
        return out


def family_self(model, tag: str) -> dict:
    """11e: 64 teacher-forced decode steps at batch 1 against `forward`.
    The SSM and hybrid forward run at ssm_chunk 64, as test_archs.py
    replaces the chunk (the SSD asserts a chunk multiple); the MoE runs at
    moe_group 1 after its seed-0 run: its reference dispatch counts
    capacity slots per top-k rank (a cumsum over the group for each rank),
    so two tokens routed to one expert at different ranks share a slot and
    the expert runs on their sum, and a decode step (a group of one)
    equals a forward only where the forward groups each token alone.

    Logits at full depth, measured on the seed-0 weights, then on the same
    weights with every attention projection at its contraction
    dimension's fan-in (`fan_in_attention`; the SSM has none). The
    reference's gates (relative RMS <= 0.05, agreement >= 0.9) hold the
    enc-dec there. The others part past them with depth, in the reference
    as in the port (`tests/test_torch_lm_families.py --depth-sweep`: the
    reference's init amplifies a bf16 rounding of the SSM state about 1.7x
    a layer, and in the MoE a rounding swaps one of 64 experts where two
    lie within it; the share of (token, layer) routed differently is
    printed), so they are gated at full width on a model of
    FAMILY_GATE_DEPTH[arch] layers drawn from seed 0 (fan-in attention
    where the family has attention). Every family is then gated layer by
    layer at full depth (`LayerTape`): each decode layer, on the forward's
    input to it, adds what the forward's adds within relative RMS
    LAYER_RMS_MAX."""
    cfg = model.cfg
    gen = torch.Generator(device="cpu").manual_seed(FAMILY_SELF_SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, LM_SELF_TOKENS),
                         generator=gen).to(model.device)
    batch = family_batch(cfg, toks.cpu(), gen, model.device)
    fwd = {}
    if cfg.family in ("ssm", "hybrid") and LM_SELF_TOKENS % cfg.ssm_chunk:
        fwd["ssm_chunk"] = LM_SELF_TOKENS
    chunk = " at ssm_chunk 64" if fwd else ""
    moe = dict(moe_group=1) if cfg.family == "moe" else {}

    def twins(m, **changes):
        return (twin(m, **fwd, **changes) if fwd or changes else m,
                twin(m, **changes) if changes else m)

    def logits(m, label, gate, **changes):
        m_fwd, m_dec = twins(m, **changes)
        with RoutingLog() as fwd_route:
            (full, _), fwd_ms = sync_wall_ms(lambda: m_fwd.forward(batch))
        caches = decode_caches(m_dec, batch, 1, LM_SELF_TOKENS)
        with RoutingLog() as dec_route:
            (dec, _), dec_ms = sync_wall_ms(
                lambda: decode_tokens(m_dec, toks, caches))
        check(bool(torch.isfinite(dec.float()).all())
              and bool(torch.isfinite(full.float()).all()),
              f"{tag}: non-finite logits")
        limits = (0.05, 0.9) if gate else (math.inf, 0.0)
        res = logits_agree(dec, full, f"{tag} {label}: decode vs forward",
                           *limits)
        flips = (routing_flips(fwd_route.calls, dec_route.calls)
                 if fwd_route.calls else None)
        log(f"[{tag}] {label}{'' if gate else ' (measured, not gated)'}: "
            f"{LM_SELF_TOKENS} teacher-forced steps vs forward{chunk}: "
            f"relative RMS {res['rel_rms']:.4f}, agreement "
            f"{res['agreement']:.3f}{' (gates 0.05, 0.9)' if gate else ''}"
            f"{'' if flips is None else f'; routed differently {flips:.4f}'}"
            f"; forward {fwd_ms:.1f} ms, decode {dec_ms:.0f} ms")
        return dict(res, gated=gate, routing_flips=flips, forward_ms=fwd_ms,
                    decode_ms=dec_ms)

    out = dict(seed0=logits(model, "seed-0 weights", False))
    label = "seed-0 weights"
    if cfg.family != "ssm":
        out["rescaled"] = fan_in_attention(model)
        label = (f"fan-in attention ({out['rescaled']} projections)"
                 f"{', moe_group 1' if moe else ''}")
        out["fan_in"] = logits(model, label, cfg.family == "encdec", **moe)
    depth = FAMILY_GATE_DEPTH.get(cfg.name)
    if depth is not None:
        cut = Model(dataclasses.replace(cfg, num_layers=depth),
                    device=model.device, seed=0)
        if cfg.family != "ssm":
            fan_in_attention(cut)
        out["gate_depth"] = depth
        out["cut"] = logits(cut, f"{label}, {depth} of {cfg.num_layers} "
                            "layers", True, **moe)
        del cut
    m_fwd, m_dec = twins(model, **moe)
    tape = LayerTape()
    tape.forward(m_fwd, batch)
    tape.decode(m_dec, toks, decode_caches(m_dec, batch, 1, LM_SELF_TOKENS))
    rms = tape.layer_rms()
    worst = max(range(len(rms)), key=rms.__getitem__)
    check(rms[worst] <= LAYER_RMS_MAX, f"{tag} layerwise: layer {worst} "
          f"relative RMS {rms[worst]:.4f} (<= {LAYER_RMS_MAX})")
    out["layerwise"] = dict(layers=len(rms), max_rel_rms=rms[worst],
                            worst_layer=worst,
                            median_rel_rms=sorted(rms)[len(rms) // 2])
    log(f"[{tag}] layerwise, {label}{chunk}: {len(rms)} decoder layers, "
        f"each decode layer on the forward's input vs the forward's layer "
        f"over {LM_SELF_TOKENS} positions: relative RMS median "
        f"{out['layerwise']['median_rel_rms']:.4f}, max {rms[worst]:.4f} "
        f"(layer {worst}; gate {LAYER_RMS_MAX})")
    return out


def phase_family(name: str, tag: str) -> dict:
    """11a-11d for one arch at full width and depth from seed-0 weights
    through `serve.run_lm` (batch 4, prefill 512, decode 64), then its
    11e."""
    args = serve_driver.parser().parse_args(
        FAMILY_TRAFFIC + ["--arch", name] + FAMILY_FLAGS.get(name, []))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = sync_wall_ms(lambda: serve_driver.lm_model(args))
    cfg = model.cfg
    res = lm_serve(args, model, tag)
    log(f"[{tag}] weights drawn in {init_ms:.0f} ms ({cfg.param_dtype})")
    res.update(init_ms=init_ms, param_dtype=cfg.param_dtype)
    res["self"] = timed_phase(f"{tag} 11e", family_self, model,
                              f"families 11e {name}")
    del model
    torch.cuda.empty_cache()
    return res


def card_vs_cpu_family(name: str, dev) -> dict:
    """11f: reduced `name` under float32 compute (chunks 8): forward,
    prefill and 8 decode steps of the same weights on `dev` and on the
    CPU. Returns the largest |Δ| over max|logit| and the relative RMS of
    each; forward and prefill are checked against rtol 1e-4 and atol 1e-4
    x max|logit| (as 10d), the decode too, or within 3e-3 x max|logit| and
    relative RMS 1.5e-3 for a family in BF16_STATE_FAMILIES."""
    cfg = dataclasses.replace(reduced(get_arch(name)), dtype="float32",
                              attn_chunk=8, ssm_chunk=8)
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    gen = torch.Generator(device="cpu").manual_seed(LM_SELF_SEED)
    s = 16 if cfg.family in ("ssm", "hybrid") else CARD_CPU_PROMPT
    prompt = torch.randint(0, cfg.vocab_size, (2, s), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, CARD_CPU_DECODE),
                         generator=gen)
    enc = torch.randn((2, 12, cfg.d_model), generator=gen).bfloat16()

    def batch(d):
        out = dict(tokens=prompt.to(d))
        if cfg.family == "encdec":
            out["enc_embeds"] = enc.to(d)
        return out

    def decode(m, d):
        caches = decode_caches(m, batch(d), 2, CARD_CPU_DECODE)
        return decode_tokens(m, toks.to(d), caches)[0]

    out = {}
    for label, fn in (("forward", lambda m, d: m.forward(batch(d))[0]),
                      ("prefill", lambda m, d: m.prefill(batch(d))[0]),
                      ("decode", decode)):
        want, got = fn(cpu, "cpu"), fn(card, dev).cpu()
        scale = float(want.abs().max())
        err = (got - want).abs()
        rms = float(torch.sqrt((err ** 2).mean())
                    / torch.sqrt((want ** 2).mean()))
        within_1e4 = bool((err <= 1e-4 * scale + 1e-4 * want.abs()).all())
        if label == "decode" and cfg.family in BF16_STATE_FAMILIES:
            check(float(err.max()) <= 3e-3 * scale and rms <= 1.5e-3,
                  f"card vs CPU {name} {label}: max |Δ| {float(err.max())} "
                  f"(max|logit| {scale}), relative RMS {rms}")
        else:
            check(within_1e4, f"card vs CPU {name} {label}: max |Δ| "
                  f"{float(err.max())} (max|logit| {scale})")
        out[label] = dict(max_rel=float(err.max()) / scale, rel_rms=rms,
                          within_1e4=within_1e4)
    return out


def phase_families_card_vs_cpu() -> dict:
    """11f for reduced arctic-480b and the four archs of 11a-11d."""
    out = {}
    for name in CARD_CPU_FAMILIES:
        out[name] = res = card_vs_cpu_family(name, torch.device("cuda"))
        log(f"[families 11f] reduced {name}, float32: max |Δ| / max|logit| "
            f"card vs CPU forward {res['forward']['max_rel']:.2e}, prefill "
            f"{res['prefill']['max_rel']:.2e}, 8 decode steps "
            f"{res['decode']['max_rel']:.2e} (relative RMS "
            f"{res['decode']['rel_rms']:.2e}; within rtol/atol 1e-4: "
            f"{res['decode']['within_1e4']})")
    return out


def phase_families() -> dict:
    """Phase 11: 11a-11d (with each arch's 11e) and 11f."""
    out = {}
    for tag, name in zip(("11a", "11b", "11c", "11d"), FAMILY_ARCHS):
        out[name] = timed_phase(f"families {tag}", phase_family, name,
                                f"families {tag}")
    out["card_vs_cpu"] = timed_phase("families 11f",
                                     phase_families_card_vs_cpu)
    return out


# ---------------------------------------------------------------------------
# Phase 12: LM training
# ---------------------------------------------------------------------------

LM_TRAIN = ["--device", "cuda", "--arch", "qwen1.5-0.5b", "--batch", "8",
            "--seq", "1024", "--steps", "12", "--save-every", "6"]
LM_TRAIN_WARMUP = 2                  # 12a: steps left out of the median
BF16_DENSE_OPS_PER_S = 989e12        # H100 SXM, bf16 tensor cores, dense
SSM_TRAIN = dict(arch="mamba2-780m", batch=4, seq=512, steps=3)
TRAIN_FAMILIES = ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "arctic-480b",
                  "mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2")
TRAIN_CARD_SEQ = 16                  # 12c: tokens a sequence
LM_RESUME = ["--device", "cuda", "--arch", "qwen1.5-0.5b", "--reduced",
             "--batch", "2", "--seq", "32", "--steps", "6", "--save-every",
             "2"]
LM_RESUME_AT = 4                     # 12d: the preempted run stops here


def model_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of a training step: 6 N a token for the weights and
    12 L H hd S a token for the attention scores and values (forward and
    backward, no remat, causal mask not credited)."""
    n = cfg.param_count()
    attn = 0
    if cfg.num_heads:
        layers = cfg.num_layers + cfg.encoder_layers
        attn = 12 * layers * cfg.padded_heads * cfg.head_dim_ * seq
    return (6 * n + attn) * tokens


def phase_lm_train_driver(argv: list = LM_TRAIN) -> dict:
    """12a: the training driver at full width (see the module
    docstring)."""
    root = os.path.join(ROOT, "build", "lm_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    args = train_driver.parser().parse_args(argv + ["--ckpt-dir", root])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = sync_wall_ms(lambda: serve_driver.lm_model(args))
    cfg = model.cfg
    # On the host, so that the peak below is the driver's own.
    before = [p.detach().to("cpu", copy=True) for p in model.parameters()]
    try:
        out = train_driver.run(args, model=model,
                               log=lambda m: log(f"[lm-train 12a] {m}"))
        saved = sorted(os.listdir(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                 for m in out["metrics"])
    check(finite, f"lm-train 12a: non-finite loss or grad norm "
          f"{out['metrics']}")
    unchanged = [i for i, (a, p) in enumerate(zip(before,
                                                  model.parameters()))
                 if torch.equal(a, p.detach().cpu())]
    del before
    check(not unchanged, f"lm-train 12a: {len(unchanged)} parameters did "
          "not change")
    check(saved == [f"step_{s:08d}" for s in (6, 12)],
          f"lm-train 12a: checkpoints {saved}")
    warm = sorted(out["step_ms"][LM_TRAIN_WARMUP:])
    median = warm[len(warm) // 2]
    tokens = args.batch * args.seq
    flops = model_flops(cfg, tokens, args.seq)
    # One more warm step of the driver's own step under the profiler.
    opt_cfg = train_driver.opt_config(args, cfg)
    step = train_driver.make_step(model, opt_cfg,
                                  train_driver.CompressionConfig())
    batch = lm_data.synthetic_batch(cfg, ShapeConfig(
        "custom", "train", args.seq, args.batch), args.steps,
        device=model.device)
    state = out["opt_state"]
    # The step's new optimizer state is dropped at once, so that the peak
    # stays the driver's own (its old and new states, not a third).
    wall = sync_wall_ms(lambda: step(state, batch)[1])[1]
    busy, top = device_profile(lambda: step(state, batch)[1])
    peak = torch.cuda.max_memory_allocated()
    res = dict(arch=cfg.name, batch=args.batch, seq=args.seq,
               steps=args.steps, params=sum(p.numel()
                                             for p in model.parameters()),
               param_count=cfg.param_count(), init_ms=init_ms,
               step_ms=out["step_ms"], median_ms=median,
               tokens_per_s=tokens / (median / 1e3), peak_bytes=peak,
               profiled_wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
               top_kernels=top[:6], model_flops=flops,
               flop_share=flops / (median / 1e3) / BF16_DENSE_OPS_PER_S,
               losses=[m["loss"] for m in out["metrics"]],
               grad_norms=[m["grad_norm"] for m in out["metrics"]],
               saved=saved)
    log(f"[lm-train 12a] {cfg.name} full width ({res['params']} "
        f"parameters, {cfg.param_dtype} masters, {cfg.dtype} compute): "
        f"batch {args.batch} x {args.seq}, {args.steps} steps; weights "
        f"drawn in {init_ms:.0f} ms; step walls "
        f"{[round(x, 1) for x in out['step_ms']]} ms; median of the warm "
        f"steps {median:.1f} ms, {res['tokens_per_s']:.0f} tokens/s; "
        f"peak {peak / 1e9:.2f} GB; losses "
        f"{[round(x, 4) for x in res['losses']]}; grad norms "
        f"{[round(x, 3) for x in res['grad_norms']]}; checkpoints "
        f"{saved} (removed); one more warm step {wall:.1f} ms wall, "
        f"{busy:.1f} ms device-busy ({100 * busy / wall:.1f}%), top kernels "
        f"{[(k, round(v, 2)) for k, v in top[:6]]}; model FLOPs "
        f"{flops / 1e12:.2f} T a step, {100 * res['flop_share']:.1f}% of "
        f"989 TFLOP/s bf16 dense at the median step ({card_line()})")
    return res


def phase_lm_train_ssm(cfg_run: dict = SSM_TRAIN,
                       dev=torch.device("cuda")) -> dict:
    """12b: full-width mamba2 (see the module docstring)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(cfg_run["arch"])
    model = Model(cfg, device=dev, seed=0)
    opt_cfg = lm_steps.make_opt_cfg(cfg)
    state = lm_steps._opt_module(cfg).init(model.params(), opt_cfg)
    step = lm_steps.make_train_step(model, opt_cfg)
    shape = ShapeConfig("custom", "train", cfg_run["seq"], cfg_run["batch"])
    batch = lm_data.synthetic_batch(cfg, shape, 0, device=dev)
    model.requires_grad_(True)
    leaves = ckpt.flatten(model.params())

    def nonfinite_leaves() -> int:
        _, grads = lm_steps.grads_of(model, batch, leaves)
        return sum(not bool(torch.isfinite(g).all()) for g in grads)

    # The reference's intra-chunk weight, where(mask, exp(decay), 0): its
    # backward is NaN wherever exp overflows above the diagonal (F9).
    f9 = mamba_mod.intra_chunk_weight
    mamba_mod.intra_chunk_weight = lambda decay, mask: torch.where(
        mask, torch.exp(decay), 0.0)
    try:
        before_f9 = nonfinite_leaves()
    finally:
        mamba_mod.intra_chunk_weight = f9
    bad, grad_ms = sync_wall_ms(nonfinite_leaves)
    check(before_f9 > 0, "lm-train 12b: the reference's intra-chunk weight "
          "gave a finite gradient; F9's case did not arise")
    check(not bad, f"lm-train 12b: {bad} of {len(leaves)} gradient leaves "
          "non-finite")
    walls, norms, losses = [], [], []
    for i in range(cfg_run["steps"]):
        batch = lm_data.synthetic_batch(cfg, shape, i, device=dev)
        (state, metrics), ms = sync_wall_ms(lambda: step(state, batch))
        walls.append(ms)
        norms.append(float(metrics["grad_norm"]))
        losses.append(float(metrics["loss"]))
    check(all(math.isfinite(x) for x in norms + losses),
          f"lm-train 12b: grad norms {norms}, losses {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "lm-train 12b: non-finite parameters")
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm-train 12b] {cfg.name} full width ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, ssm_chunk {cfg.ssm_chunk}, "
        f"{sum(p.numel() for p in model.parameters())} parameters): with "
        f"the reference's intra-chunk weight {before_f9} of {len(leaves)} "
        f"gradient leaves non-finite; with the port's (F9) all "
        f"{len(leaves)} finite ({grad_ms:.0f} ms); "
        f"{cfg_run['steps']} steps of make_train_step at batch "
        f"{cfg_run['batch']} x {cfg_run['seq']}: walls "
        f"{[round(x, 1) for x in walls]} ms, losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in norms]} (finite); peak {peak / 1e9:.2f} GB")
    return dict(arch=cfg.name, grad_leaves=len(leaves), grad_ms=grad_ms,
                nonfinite_before_f9=before_f9,
                step_ms=walls, losses=losses, grad_norms=norms,
                peak_bytes=peak)


def train_step_on(model, name: str) -> tuple:
    """One `make_train_step` of `model` on step 0's synthetic batch at the
    full rate (a warmup of one step: an update far above float32 rounding
    that moves bf16 parameters): (optimizer state, metrics as floats)."""
    cfg = model.cfg
    shape = ShapeConfig("custom", "train", TRAIN_CARD_SEQ,
                        max(2, cfg.microbatches))
    batch = lm_data.synthetic_batch(cfg, shape, 0, device=model.device)
    opt_cfg = dataclasses.replace(lm_steps.make_opt_cfg(cfg), warmup_steps=1)
    state = lm_steps._opt_module(cfg).init(model.params(), opt_cfg)
    state, metrics = lm_steps.make_train_step(model, opt_cfg)(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}


def bf16_ulp(x):
    """One bf16 ulp of each element's magnitude (that of 1 at 0)."""
    mag = x.float().abs()
    return torch.exp2(torch.floor(torch.log2(torch.where(
        mag > 0, mag, torch.ones_like(mag)))) - 7)


def card_vs_cpu_train(name: str, dev) -> dict:
    """12c for one arch: each parameter's update on the card against the
    CPU's, and the optimizer state after one step. AdamW's float32
    parameters: the update within 1e-3 lr plus two float32 ulps of the
    parameter on the elements whose gradient (the CPU's first moment,
    (1 - b1) g) exceeds 1e-2 of its leaf's largest; below that Adam's
    g / (|g| + eps) may take either sign. Adafactor's bf16 parameters:
    the leaves that move on the CPU move on the card, some by two ulps or
    more, and land within one ulp."""
    cfg = dataclasses.replace(reduced(get_arch(name)), dtype="float32",
                              attn_chunk=8, ssm_chunk=8)
    cpu = Model(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in cpu.state_dict().items()}
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(dev, copy=True)
                          for k, v in before.items()}, assign=True)
    s_cpu, m_cpu = train_step_on(cpu, name)
    s_card, m_card = train_step_on(card, name)
    for k in ("loss", "grad_norm", "lr"):
        check(abs(m_card[k] - m_cpu[k]) <= 1e-4 * abs(m_cpu[k]),
              f"lm-train 12c {name} {k}: card {m_card[k]} CPU {m_cpu[k]}")
    lr = m_cpu["lr"]
    grads = dict(leaves(s_cpu.m)) if hasattr(s_cpu, "m") else {}
    worst, bf16_ulps = 0.0, 0.0
    for (k, want), got in zip(cpu.state_dict().items(),
                              card.state_dict().values()):
        got, p0 = got.cpu().float(), before[k].float()
        d_got, d_want = got - p0, want.float() - p0
        if want.dtype == torch.bfloat16:
            ulp = bf16_ulp(p0)
            far = bool((d_want.abs() >= 2 * ulp).any())
            check(bool((d_got != 0).any()) == bool((d_want != 0).any())
                  == far, f"lm-train 12c {name} {k}: moved on the card "
                  f"{bool((d_got != 0).any())}, on the CPU "
                  f"{bool((d_want != 0).any())}, two ulps or more {far}")
            bf16_ulps = max(bf16_ulps, float(((got - want.float()).abs()
                                              / ulp).max()))
            continue
        g = grads[k]
        clear = g.abs() > 1e-2 * g.abs().max()
        err = (d_got - d_want).abs()[clear]
        mag = p0.abs()[clear]
        ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
        bound = 1e-3 * lr + 2 * ulp
        check(bool(clear.any()) and bool((d_got != 0).any()),
              f"lm-train 12c {name} {k}: the leaf did not move")
        check(bool((err <= bound).all()), f"lm-train 12c {name} {k}: update "
              f"{float(err.max()) / lr:.2e} lr from the CPU's")
        worst = max(worst, float(err.max()) / lr)
    check(bf16_ulps <= 1, f"lm-train 12c {name}: bf16 parameters "
          f"{bf16_ulps} ulps apart")
    # The moments hold the gradients; arctic's are rounded to bf16 and
    # summed over 16 microbatches in bf16, so a rounding flips now and
    # then (tests/test_torch_lm_train.py holds them so too).
    limit = 2.5e-2 if cfg.param_dtype == "bfloat16" else 1e-4
    moments = max(float((a.cpu().float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30)
                  for a, b in zip(ckpt.flatten(s_card)[:-1],
                                  ckpt.flatten(s_cpu)[:-1]))
    check(moments <= limit, f"lm-train 12c {name}: optimizer state "
          f"{moments:.2e} (limit {limit})")
    return dict(loss=m_card["loss"], loss_cpu=m_cpu["loss"],
                grad_norm=m_card["grad_norm"], grad_norm_cpu=m_cpu[
                    "grad_norm"], lr=lr, update_max_err_lr=worst,
                bf16_param_ulps=bf16_ulps, moments_max_rel=moments)


def phase_lm_train_card_vs_cpu() -> dict:
    """12c: every family reduced, card against CPU (module docstring)."""
    out = {}
    for name in TRAIN_FAMILIES:
        out[name] = res = card_vs_cpu_train(name, torch.device("cuda"))
        log(f"[lm-train 12c] reduced {name}, float32 compute, one train "
            f"step: loss card {res['loss']:.6f} / CPU {res['loss_cpu']:.6f},"
            f" grad norm {res['grad_norm']:.6f} / {res['grad_norm_cpu']:.6f}"
            f"; lr {res['lr']:.2e}, float32 updates max |Δ| "
            f"{res['update_max_err_lr']:.2e} lr (bound 1e-3 lr plus two "
            f"ulps; bf16 parameters {res['bf16_param_ulps']:.0f} ulps), "
            f"optimizer state {res['moments_max_rel']:.2e} (bound 1e-4, "
            f"arctic 2.5e-2)")
    return out


class PreemptAt(FaultManager):
    """A FaultManager that takes a preemption notice at step `at` (its
    SIGTERM handler called directly, no signal sent)."""

    def __init__(self, cfg, at: int):
        super().__init__(dataclasses.replace(cfg, install_sigterm_hook=False))
        self.at = at

    def maybe_save(self, step, tree):
        if step == self.at:
            self._on_sigterm(15, None)
        return super().maybe_save(step, tree)


def phase_lm_train_resume(argv: list = LM_RESUME) -> dict:
    """12d: resume bit-equal on the card (module docstring). The runs'
    checkpoints go under build/lm_resume and are removed after."""
    root = os.path.join(ROOT, "build", "lm_resume")
    shutil.rmtree(root, ignore_errors=True)

    def args_of(name):
        return train_driver.parser().parse_args(
            argv + ["--ckpt-dir", os.path.join(root, name)])

    quiet = lambda m: None  # noqa: E731
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pre_args = args_of("resumed")
            first = train_driver.run(pre_args, log=quiet, fault_manager=(
                PreemptAt(FaultConfig(ckpt_dir=pre_args.ckpt_dir,
                                      save_every=pre_args.save_every),
                          LM_RESUME_AT)))
            saved = sorted(os.listdir(pre_args.ckpt_dir))
            resumed = train_driver.run(pre_args, log=quiet)
            whole = train_driver.run(args_of("whole"), log=quiet)
        nondet = sorted({str(w.message).split("\n")[0][:120] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(root, ignore_errors=True)
    check(first["stopped"] and len(first["metrics"]) == LM_RESUME_AT,
          "lm-train 12d: the preempted run did not stop at step "
          f"{LM_RESUME_AT}")
    check(resumed["start"] == LM_RESUME_AT, "lm-train 12d: resumed from "
          f"step {resumed['start']}")
    same_params = [torch.equal(a, b) for a, b in zip(
        resumed["model"].state_dict().values(),
        whole["model"].state_dict().values())]
    same_state = [torch.equal(a, b) for a, b in zip(
        ckpt.flatten(resumed["opt_state"]), ckpt.flatten(whole["opt_state"]))]
    same_metrics = resumed["metrics"] == whole["metrics"][LM_RESUME_AT:]
    log(f"[lm-train 12d] reduced qwen1.5-0.5b through the driver, "
        f"deterministic algorithms: 6-step run preempted after step "
        f"{LM_RESUME_AT} (saved {saved}), restarted from step "
        f"{resumed['start']}: parameters bit-equal to 6 uninterrupted "
        f"steps {sum(same_params)}/{len(same_params)}, optimizer state "
        f"{sum(same_state)}/{len(same_state)}, metrics of steps 5-6 "
        f"{same_metrics}; nondeterministic-op warnings {nondet or 'none'}; "
        f"build/lm_resume removed {not os.path.exists(root)}")
    check(all(same_params) and all(same_state) and same_metrics,
          "lm-train 12d: the resumed run differs from the uninterrupted one")
    return dict(saved=saved, bit_equal=True,
                nondeterministic_warnings=nondet)


def phase_lm_train() -> dict:
    """Phase 12: 12a-12d; none of the four kernels is launched."""
    reset_launches()
    prtu.dense_launches = render.full_launches = 0
    out = dict(driver=timed_phase("lm-train 12a", phase_lm_train_driver))
    torch.cuda.empty_cache()
    out["ssm"] = timed_phase("lm-train 12b", phase_lm_train_ssm)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = timed_phase("lm-train 12c",
                                     phase_lm_train_card_vs_cpu)
    out["resume"] = timed_phase("lm-train 12d", phase_lm_train_resume)
    launches = dict(launches_now(), prtu_cat_mask=prtu.dense_launches,
                    blend_tiles=render.full_launches)
    check(not any(launches.values()),
          f"lm-train: the LM's training path launched kernels {launches}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 13: the dense LM over a mesh of virtual shards
# ---------------------------------------------------------------------------

LM_MESH_ARCH = "qwen1.5-0.5b"
LM_MESH_SHAPE = (2, 2)               # (data, model): 4 virtual shards
LM_MESH_F32 = dict(batch=4, seq=1024, steps=3)       # 13a, float32
LM_MESH_BF16 = dict(batch=8, seq=1024, steps=3)      # 13a, 12a's shape
LM_MESH_SERVE = dict(batch=4, prefill=64, decode=16, seed=23)   # 13b
LM_MESH_RESUME = dict(batch=4, seq=32, steps=2)      # 13c, reduced
LM_MESH_SEED = 24                    # 13b-13d prompts and batches


def lm_mesh(shape, dev, names=("data", "model")):
    """A mesh of `prod(shape)` virtual shards of `dev`."""
    flat = [dev] * math.prod(shape)
    for n in reversed(shape[1:]):
        flat = [flat[i:i + n] for i in range(0, len(flat), n)]
    return Mesh(flat, names)


def lm_mesh_args(run: dict, cfg) -> argparse.Namespace:
    """The training driver's arguments for `run`: its AdamW schedule over
    run["steps"] steps (warmup 1) and its whole-batch step."""
    return train_driver.parser().parse_args(
        ["--arch", cfg.name, "--batch", str(run["batch"]), "--seq",
         str(run["seq"]), "--steps", str(run["steps"])])


def replicas_equal(tree) -> bool:
    """Every piece of every `Sharded` leaf bit-equal to the first holder
    of its block."""
    return all(torch.equal(t.pieces[i], t.pieces[g[0]])
               for t in ckpt.flatten(tree) if isinstance(t, Sharded)
               for g in t.sharding.replica_groups() for i in g[1:])


def update_error(before, after, want_before, want_after, grad, lr) -> float:
    """The update gate of 12c and `tests/test_torch_lm_train.py` over flat
    dicts of whole tensors: the worst |Δ update| / lr past two float32
    ulps of the parameter, over the elements whose gradient `grad`
    exceeds 1e-2 of its leaf's largest."""
    worst = 0.0
    for k, g in grad.items():
        sel = g.abs() > 1e-2 * g.abs().max()
        d = ((after[k] - before[k]) - (want_after[k] - want_before[k])).abs()
        mag = after[k].abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
        err = (d - 2 * ulp)[sel]
        if err.numel():
            worst = max(worst, float(err.max()) / lr)
    return worst


def mesh_and_one(cfg, mesh, dev, label, seed=0, fan_in=False) -> tuple:
    """(one-device model, the model on `mesh`) of `cfg` from one draw,
    the mesh's placed from the same seed and checked bit-equal; with
    `fan_in`, both then hold the one-device model's weights after
    `fan_in_attention`."""
    one = Model(cfg, device=dev, seed=seed)
    sh = Model(cfg, device=dev, seed=seed, mesh=mesh)
    same = all(torch.equal(sh.state_dict()[k], v)
               for k, v in one.state_dict().items())
    check(same, f"{label}: the sharded model's weights differ from the "
          "one-device model's")
    if fan_in:
        fan_in_attention(one)
        sh.load_state_dict(one.state_dict())
    return one, sh


def mesh_steps_against_one(cfg, mesh, run, dev, label, seed=0,
                           fan_in=False) -> dict:
    """`run["steps"]` driver steps (AdamW, whole batch) of `cfg` on `mesh`
    and on one device from the same weights (`mesh_and_one`) and batches:
    per step the loss and grad norm (relative |Δ|), the update gate
    (`update_error`, the gradient read from the one-device run's first
    moments) and the replicas; step walls of both. Each step after the
    first starts the mesh from the one-device run's parameters and
    moments (placed by `opt_shardings`), so that every step's update is
    held as one step from one state (12c's criterion), not two
    trajectories that part by their earlier roundings."""
    args = lm_mesh_args(run, cfg)
    opt_cfg = train_driver.opt_config(args, cfg)
    comp = train_driver.CompressionConfig()
    one, sh = mesh_and_one(cfg, mesh, dev, label, seed, fan_in)
    steps = [train_driver.make_step(m, opt_cfg, comp) for m in (one, sh)]
    states = [adamw.init(m.params(), opt_cfg) for m in (one, sh)]
    shape = ShapeConfig("custom", "train", run["seq"], run["batch"])
    rows, walls = [], ([], [])
    o_shard = lm_steps.opt_shardings(sh, mesh)
    for i in range(run["steps"]):
        batch = lm_data.synthetic_batch(cfg, shape, i, device=dev)
        if i:
            sh.load_state_dict(one.state_dict())
            states[1] = D.shard_tree(states[0], o_shard)
        before = [{k: v.clone() for k, v in m.state_dict().items()}
                  for m in (one, sh)]
        m_prev = {k: v.clone() for k, v in pspec_leaves(states[0].m)}
        mets = []
        for j, m in enumerate((one, sh)):
            (states[j], met), ms = sync_wall_ms(
                lambda j=j: steps[j](states[j], batch))
            walls[j].append(ms)
            mets.append({k: float(v) for k, v in met.items()})
        grad = {k: (v - opt_cfg.b1 * m_prev[k]) / (1 - opt_cfg.b1)
                for k, v in pspec_leaves(states[0].m)}
        err = update_error(before[1], sh.state_dict(), before[0],
                           one.state_dict(), grad, mets[0]["lr"])
        rel = {k: abs(mets[1][k] - mets[0][k]) / abs(mets[0][k])
               for k in ("loss", "grad_norm")}
        reps = replicas_equal(sh.params()) and replicas_equal(states[1])
        rows.append(dict(loss=mets[1]["loss"], loss_one=mets[0]["loss"],
                         rel=rel, update_err_lr=err, replicas=reps))
        check(rel["loss"] <= 1e-5 and rel["grad_norm"] <= 1e-5,
              f"{label} step {i}: loss/grad norm relative |Δ| {rel}")
        check(err <= 1e-3, f"{label} step {i}: update |Δ| {err:.2e} lr")
        check(reps, f"{label} step {i}: replicas differ")
        del before, m_prev, grad
    return dict(rows=rows, mesh_ms=walls[1], one_ms=walls[0],
                models=(one, sh), states=states)


def pspec_leaves(tree) -> list:
    return [(k, v.gather() if isinstance(v, Sharded) else v)
            for k, v in leaves(tree)]


def phase_lm_mesh_train(dev=torch.device("cuda")) -> dict:
    """13a: full-width qwen over 4 virtual shards (module docstring)."""
    mesh = lm_mesh(LM_MESH_SHAPE, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(LM_MESH_ARCH), dtype="float32")
    chaos = seed0_spread(cfg, mesh, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = mesh_steps_against_one(cfg, mesh, LM_MESH_F32, dev, "lm-mesh 13a",
                                 fan_in=True)
    f32_peak = torch.cuda.max_memory_allocated()
    rows = res.pop("rows")
    del res
    log(f"[lm-mesh 13a] {cfg.name} full width, float32, batch "
        f"{LM_MESH_F32['batch']} x {LM_MESH_F32['seq']}, seed-0 weights "
        f"(the reference's init) forward: logits mesh vs one device "
        f"{chaos['mesh_vs_one']:.2e} x max|logit|, one device against itself"
        f" with the batch in two halves {chaos['split_vs_whole']:.2e}, loss "
        f"rel {chaos['loss_rel']:.2e} (reported: a last-place difference "
        f"grows several-fold a layer, 10c); gated on the same weights with "
        f"`fan_in_attention`: driver steps (AdamW, "
        f"whole batch) over (data=2, model=2) virtual shards vs one device: "
        + "; ".join(f"step {i}: loss {r['loss']:.6f} / {r['loss_one']:.6f} "
                    f"(rel {r['rel']['loss']:.1e}), grad norm rel "
                    f"{r['rel']['grad_norm']:.1e}, updates {r['update_err_lr']:.1e}"
                    f" lr past two ulps, replicas bit-equal {r['replicas']}"
                    for i, r in enumerate(rows))
        + f" (bounds 1e-5, 1e-5, 1e-3 lr); peak {f32_peak / 1e9:.2f} GB "
        f"({card_line()})")
    torch.cuda.empty_cache()

    # bf16 at 12a's shape: the sharded step's cost on one card.
    cfg = get_arch(LM_MESH_ARCH)
    run = LM_MESH_BF16
    args = lm_mesh_args(run, cfg)
    opt_cfg = train_driver.opt_config(args, cfg)
    shape = ShapeConfig("custom", "train", run["seq"], run["batch"])
    timing = {}
    for label, m_ in (("one", None), ("mesh", mesh)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev, seed=0, mesh=m_)
        step = train_driver.make_step(model, opt_cfg,
                                      train_driver.CompressionConfig())
        state = adamw.init(model.params(), opt_cfg)
        walls, losses = [], []
        for i in range(run["steps"]):
            batch = lm_data.synthetic_batch(cfg, shape, i, device=dev)
            (state, met), ms = sync_wall_ms(lambda: step(state, batch))
            walls.append(ms)
            losses.append(float(met["loss"]))
        wall = sync_wall_ms(lambda: step(state, batch)[1])[1]
        busy, top = device_profile(lambda: step(state, batch)[1])
        timing[label] = dict(step_ms=walls, median_ms=sorted(walls[1:])[
            (len(walls) - 1) // 2], losses=losses, busy_ms=busy,
            wall_ms=wall, busy_share=busy / wall, top_kernels=top[:5],
            peak_bytes=torch.cuda.max_memory_allocated())
        check(all(math.isfinite(x) for x in losses),
              f"lm-mesh 13a bf16 {label}: losses {losses}")
        del model, step, state
    one, sh = timing["one"], timing["mesh"]
    log(f"[lm-mesh 13a] {cfg.name} bf16 compute, batch {run['batch']} x "
        f"{run['seq']}, {run['steps']} driver steps: one device step walls "
        f"{[round(x, 1) for x in one['step_ms']]} ms, (2, 2) virtual shards "
        f"{[round(x, 1) for x in sh['step_ms']]} ms; warm median "
        f"{sh['median_ms']:.1f} vs {one['median_ms']:.1f} ms "
        f"({100 * (sh['median_ms'] / one['median_ms'] - 1):+.1f}%); losses "
        f"{[round(x, 4) for x in sh['losses']]} vs "
        f"{[round(x, 4) for x in one['losses']]}; one more step "
        f"{sh['wall_ms']:.1f} ms wall, {sh['busy_ms']:.1f} ms device-busy "
        f"({100 * sh['busy_share']:.1f}%) vs {one['wall_ms']:.1f} / "
        f"{one['busy_ms']:.1f} ms ({100 * one['busy_share']:.1f}%); peak "
        f"{sh['peak_bytes'] / 1e9:.2f} vs {one['peak_bytes'] / 1e9:.2f} GB; "
        f"top kernels on the mesh {[(k, round(v, 2)) for k, v in sh['top_kernels']]}"
        f" ({card_line()})")
    return dict(float32=dict(rows=rows, peak_bytes=f32_peak,
                             seed0=chaos), bf16=timing)


def seed0_spread(cfg, mesh, dev) -> dict:
    """On seed-0 weights: the float32 forward's logits on the mesh against
    one device, and one device against itself with the batch in two
    halves (another GEMM shape: the spread of the sums' order alone),
    each over max|logit|; the losses' relative |Δ|."""
    one, sh = mesh_and_one(cfg, mesh, dev, "lm-mesh 13a seed 0")
    run = LM_MESH_F32
    batch = lm_data.synthetic_batch(cfg, ShapeConfig(
        "custom", "train", run["seq"], run["batch"]), 0, device=dev)
    half = run["batch"] // 2
    with torch.no_grad():
        want = one.forward(batch)[0]
        scale = float(want.abs().max())
        got = sh.forward(batch)[0]
        mesh_err = float((got - want).abs().max()) / scale
        del got
        split = torch.cat([one.forward({k: v[:half] for k, v in
                                        batch.items()})[0],
                           one.forward({k: v[half:] for k, v in
                                        batch.items()})[0]])
        split_err = float((split - want).abs().max()) / scale
        del split, want
        l1, l2 = float(one.loss(batch)), float(sh.loss(batch))
    return dict(mesh_vs_one=mesh_err, split_vs_whole=split_err,
                loss_rel=abs(l1 - l2) / abs(l1))


def greedy(model, prompt, n: int, caches, forced=None) -> tuple:
    """Prefill `prompt`, then `n` greedy decode steps from `caches` (fed
    `forced` tokens instead where given): (prefill logits, step logits
    (B, n, V), tokens (B, n), caches, ms per step)."""
    first = model.prefill(dict(tokens=prompt))[0]
    tok = torch.argmax(first, -1)[:, None]
    outs, toks, ms = [], [], []
    for i in range(n):
        feed = tok if forced is None else forced[:, i:i + 1]
        (lg, caches), t = sync_wall_ms(lambda: model.decode_step(caches,
                                                                 feed))
        tok = torch.argmax(lg, -1)[:, None]
        outs.append(lg)
        toks.append(tok)
        ms.append(t)
    return (first, torch.stack(outs, 1), torch.cat(toks, 1), caches, ms)


def phase_lm_mesh_serve(dev=torch.device("cuda")) -> dict:
    """13b: prefill and greedy decode over the mesh (module docstring)."""
    mesh = lm_mesh(LM_MESH_SHAPE, dev)
    run = LM_MESH_SERVE
    cfg = dataclasses.replace(get_arch(LM_MESH_ARCH), dtype="float32")
    one, sh = mesh_and_one(cfg, mesh, dev, "lm-mesh 13b", fan_in=True)
    gen = torch.Generator(device="cpu").manual_seed(run["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (run["batch"], run["prefill"]),
                           generator=gen).to(dev)
    n, b = run["decode"], run["batch"]
    # Caches of the decode's length, so that every model position's block
    # of the sequence is written.
    length = n
    out = {}
    w = greedy(one, prompt, n, parity.float32_caches(
        one.init_caches(b, length)))
    g = greedy(sh, prompt, n, parity.float32_caches(
        sh.init_caches(b, length)))
    errs = dict(prefill=parity.logit_error(g[0], w[0]),
                decode=parity.logit_error(g[1], w[1]))
    same = torch.equal(g[2], w[2])
    check(all(ok for _, ok in errs.values()) and same,
          f"lm-mesh 13b float32: logits {errs}, tokens equal {same}")
    out["float32"] = dict(errors={k: e for k, (e, _) in errs.items()},
                          tokens_equal=same,
                          ms_per_token=float(np.median(g[4][1:])),
                          one_ms_per_token=float(np.median(w[4][1:])))
    # The int8 cache: the mesh decodes the one-device run's greedy tokens.
    for m in (one, sh):
        m.cfg = dataclasses.replace(cfg, kv_quant=True)
    w8 = greedy(one, prompt, n, one.init_caches(b, length))
    forced = torch.cat([torch.argmax(w8[0], -1)[:, None], w8[2][:, :-1]], 1)
    g8 = greedy(sh, prompt, n, sh.init_caches(b, length), forced=forced)
    pairs = list(zip(ckpt.flatten(g8[3]["kv"]), ckpt.flatten(w8[3]["kv"])))
    steps = max(parity.cache_steps(x, y) for x, y in pairs
                if y.dtype == torch.int8)
    # The scales (amax / 127 of each written K/V row) follow the K/V
    # values: once an earlier value has rounded to the other int8 step,
    # the later rows differ by more than float32 noise. Reported.
    scale_err = max(float((x.gather() - y).abs().max() / y.abs().max())
                    for x, y in pairs if y.dtype == torch.float32)
    agree = float((g8[2] == w8[2]).float().mean())
    err8 = parity.logit_error(g8[1], w8[1])[0]
    check(steps <= 1, f"lm-mesh 13b int8: caches {steps} steps apart")
    out["int8"] = dict(cache_steps=steps, scale_err=scale_err,
                       logits_err=err8,
                       argmax_agreement=agree,
                       ms_per_token=float(np.median(g8[4][1:])),
                       one_ms_per_token=float(np.median(w8[4][1:])))
    log(f"[lm-mesh 13b] {cfg.name} float32 (`fan_in_attention`), batch "
        f"{b}, prefill "
        f"{run['prefill']}, {n} greedy steps from fresh caches of {length} "
        f"(each model position's block written) "
        f"over (2, 2) virtual shards vs one device: float32 caches: "
        f"max |Δ| / max|logit| prefill {errs['prefill'][0]:.2e}, decode "
        f"{errs['decode'][0]:.2e} (bound 1e-4), tokens equal {same}; "
        f"{out['float32']['ms_per_token']:.1f} vs "
        f"{out['float32']['one_ms_per_token']:.1f} ms a token. int8 cache "
        f"(the mesh fed the one-device run's greedy tokens): cache elements "
        f"within {steps:.0f} step (bound 1), scales {scale_err:.2e} of "
        f"their max (reported), logits {err8:.2e} x "
        f"max|logit|, argmax agreement {agree:.3f}; "
        f"{out['int8']['ms_per_token']:.1f} vs "
        f"{out['int8']['one_ms_per_token']:.1f} ms a token ({card_line()})")
    return out


def phase_lm_mesh_resume(dev=torch.device("cuda")) -> dict:
    """13c: save on (2, 2), restore, `elastic_reshard` onto (1, 4) and
    (1, 1) (module docstring); the checkpoint under build/lm_mesh_ckpt,
    removed after."""
    root = os.path.join(ROOT, "build", "lm_mesh_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    run = LM_MESH_RESUME
    cfg = dataclasses.replace(reduced(get_arch(LM_MESH_ARCH)),
                              dtype="float32")
    opt_cfg = train_driver.opt_config(lm_mesh_args(
        dict(run, steps=2 * run["steps"]), cfg), cfg)
    comp = train_driver.CompressionConfig()
    shape = ShapeConfig("custom", "train", run["seq"], run["batch"])
    batches = [lm_data.synthetic_batch(cfg, shape, LM_MESH_SEED + i,
                                       device=dev)
               for i in range(2 * run["steps"])]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        src = Model(cfg, device=dev, seed=0, mesh=lm_mesh((2, 2), dev))
        step = train_driver.make_step(src, opt_cfg, comp)
        state = adamw.init(src.params(), opt_cfg)
        for b in batches[:run["steps"]]:
            state, _ = step(state, b)
        fm = FaultManager(FaultConfig(ckpt_dir=root, save_every=run["steps"],
                                      install_sigterm_hook=False))
        fm.maybe_save(run["steps"], (src.params(), state))
        gathered = (src.state_dict(), D.gather_tree(state))
        (params, restored), at = fm.restore_latest(
            (pspec.tree_map(lambda t: t.gather(), src.params()),
             D.gather_tree(state)))
        check(at == run["steps"], f"lm-mesh 13c: restored step {at}")
        saved = [*gathered[0].items()]
        flat_params = dict(leaves(params))
        check(all(torch.equal(flat_params[k], v) for k, v in saved)
              and all(torch.equal(a, b) for a, b in zip(
                  ckpt.flatten(restored), ckpt.flatten(gathered[1]))),
              "lm-mesh 13c: the restored state differs from the saved one")
        for shp in ((1, 4), (1, 1)):
            mesh = lm_mesh(shp, dev)
            specs = pspec.partition_specs(src.specs(), mesh)
            p2 = elastic_reshard(params, mesh, specs)
            s2 = elastic_reshard(restored, mesh, adamw.OptState(
                m=specs, v=specs, step=()))
            whole = [x.gather() if isinstance(x, Sharded) else x
                     for x in ckpt.flatten((p2, s2))]
            check(all(torch.equal(a, b) for a, b in zip(
                whole, ckpt.flatten((params, restored)))),
                f"lm-mesh 13c {shp}: resharded state differs")
            finals = []
            for how in ("resharded", "gathered"):
                m = Model(cfg, device=dev, seed=1, mesh=mesh)
                if how == "resharded":
                    m.load_state_dict({k: t.gather() for k, t in
                                       leaves(p2)})
                    st = s2 if mesh.size > 1 else D.gather_tree(s2)
                else:
                    m.load_state_dict(gathered[0])
                    st = gathered[1] if mesh.size == 1 else D.shard_tree(
                        gathered[1], lm_steps.opt_shardings(m, mesh))
                s = train_driver.make_step(m, opt_cfg, comp)
                for b in batches[run["steps"]:]:
                    st, _ = s(st, b)
                finals.append([x.gather() if isinstance(x, Sharded) else x
                               for x in ckpt.flatten((m.params(), st))])
            same = all(torch.equal(a, b) for a, b in zip(*finals))
            check(same, f"lm-mesh 13c {shp}: the steps after the reshard "
                  "differ from the same steps from the gathered state")
            out[f"{shp[0]}x{shp[1]}"] = dict(bit_equal=same)
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(root, ignore_errors=True)
    log(f"[lm-mesh 13c] reduced {cfg.name} float32, deterministic "
        f"algorithms: {run['steps']} steps on (2, 2), saved by a "
        f"FaultManager and restored bit-equal, elastic_reshard onto (1, 4) "
        f"and (1, 1) bit-equal when gathered, {run['steps']} more steps on "
        f"each bit-equal to the same steps from the gathered state: {out}; "
        f"build/lm_mesh_ckpt removed {not os.path.exists(root)}")
    return out


def phase_lm_mesh_pod(dev=torch.device("cuda")) -> dict:
    """13d: one step over (pod=2, data=2, model=2) virtual shards of
    reduced qwen, `fsdp_over_pod` off and on, against one device."""
    out = {}
    mesh = lm_mesh((2, 2, 2), dev, ("pod", "data", "model"))
    for fop in (False, True):
        cfg = dataclasses.replace(reduced(get_arch(LM_MESH_ARCH)),
                                  dtype="float32", fsdp_over_pod=fop)
        res = mesh_steps_against_one(
            cfg, mesh, dict(batch=8, seq=64, steps=1), dev,
            f"lm-mesh 13d fsdp_over_pod={fop}", seed=LM_MESH_SEED)
        out[f"fsdp_over_pod={fop}"] = res["rows"][0]
    log(f"[lm-mesh 13d] reduced {LM_MESH_ARCH} float32, batch 8 x 64, one "
        f"driver step over (pod=2, data=2, model=2) virtual shards vs one "
        f"device: " + "; ".join(
            f"{k}: loss rel {r['rel']['loss']:.1e}, grad norm rel "
            f"{r['rel']['grad_norm']:.1e}, updates {r['update_err_lr']:.1e} "
            f"lr, replicas bit-equal {r['replicas']}" for k, r in out.items())
        + " (bounds 1e-5, 1e-5, 1e-3 lr)")
    return out


def phase_lm_mesh() -> dict:
    """Phase 13: 13a-13d; none of the four kernels is launched."""
    reset_launches()
    prtu.dense_launches = render.full_launches = 0
    out = dict(train=timed_phase("lm-mesh 13a", phase_lm_mesh_train))
    torch.cuda.empty_cache()
    out["serve"] = timed_phase("lm-mesh 13b", phase_lm_mesh_serve)
    torch.cuda.empty_cache()
    out["resume"] = timed_phase("lm-mesh 13c", phase_lm_mesh_resume)
    out["pod"] = timed_phase("lm-mesh 13d", phase_lm_mesh_pod)
    launches = dict(launches_now(), prtu_cat_mask=prtu.dense_launches,
                    blend_tiles=render.full_launches)
    check(not any(launches.values()),
          f"lm-mesh: the LM's mesh path launched kernels {launches}")
    out["launches"] = launches
    return out


def write_json(path, summary: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(summary, f, indent=1, default=str)


def passes_only(summary: dict, json_path) -> int:
    """Phase 4c alone: serve the requests (which settles the plan's spill
    passes as in a full run), then time K1 and K2 on every pass of request
    0's frame. Prints the card line and, last, the per-frame sums."""
    engine, name = hd1080_engine()
    phase_serve(engine, name)
    cam = hd1080_cameras(N_REQUESTS)[0].to(engine.device)
    summary["passes"] = timed_phase(
        "passes", phase_passes, engine.plan_for(name, 1088, 1920),
        engine.scene(name), cam)
    write_json(json_path, summary)
    print(summary["card"])
    print(json.dumps(dict(summary["passes"]["sums"],
                          empty_k1_ms=summary["passes"]["empty_k1"]["ms"])))
    return 0


def offpath_only(summary: dict, json_path) -> int:
    """The off-path kernels alone: the p1024 setup, phase 6a (K4 under
    FULL_FP32 and MIXED: 0 flips on the full mask, the fp8 overflow check,
    ms and pairs) and K3 on the p1024 stream frame's lists (against its
    plain version, device ms). Prints the card line, one line of the
    times, and the contract's last line."""
    pt = timed_phase("1024 setup", p1024_setup)
    summary["k4"] = timed_phase("k4", phase_k4, pt)
    plan, scene, cam = pt["plan"], pt["scene"], pt["cam"]
    ps = plan.preprocess(scene, cam)
    ts, = plan.stage1_compact(ps)
    h = plan.ctu(ps, ts)
    operands = ops.gather_tile_features(ps.proj, ps.grid, h.lists, h.valid,
                                        h.entry_mini_mask)
    summary["k3"] = timed_phase("k3", k3_against_plain, operands,
                                "1024 frame")
    write_json(json_path, summary)
    print(json.dumps(dict(
        k4_mixed_ms=summary["k4"]["mixed"]["ms"],
        k4_fp32_ms=summary["k4"]["fp32"]["ms"],
        k3_ms=summary["k3"]["ms"])))
    print(summary["card"])
    print(ok_line())
    return 0


def sessions_only(summary: dict, json_path) -> int:
    """Phase 4g alone: the three sessions on a fresh incremental engine.
    Prints the card line and the contract's last line."""
    engine, name = session_engine()
    summary["sessions"] = timed_phase("sessions", phase_sessions, engine,
                                      name, session_cameras())
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def lod_only(summary: dict, json_path) -> int:
    """Phase 7 alone. Prints the card line and the contract's last line."""
    summary["lod"] = timed_phase("lod", phase_lod)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def shards_only(summary: dict, json_path) -> int:
    """Phase 8 alone. Prints the card line and the contract's last line."""
    summary["shards"] = timed_phase("shards", phase_shards)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def train_only(summary: dict, json_path) -> int:
    """Phase 9 alone. Prints the card line and the contract's last line."""
    summary["train"] = timed_phase("train", phase_train)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def serve_only(summary: dict, json_path) -> int:
    """Phase 10 alone. Prints the card line and the contract's last line."""
    summary["driver"] = timed_phase("serve", phase_driver)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def families_only(summary: dict, json_path) -> int:
    """Phase 11 alone. Prints the card line and the contract's last line."""
    summary["families"] = timed_phase("families", phase_families)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def lm_train_only(summary: dict, json_path) -> int:
    """Phase 12 alone. Prints the card line and the contract's last line."""
    summary["lm_train"] = timed_phase("lm-train", phase_lm_train)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def lm_mesh_only(summary: dict, json_path) -> int:
    """Phase 13 alone. Prints the card line and the contract's last line."""
    summary["lm_mesh"] = timed_phase("lm-mesh", phase_lm_mesh)
    write_json(json_path, summary)
    print(summary["card"])
    print(ok_line())
    return 0


def ok_line() -> str:
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", metavar="PATH",
                        help="also write every measurement to this file")
    parser.add_argument("--passes-only", action="store_true",
                        help="run only the build and phase 4c (K1 and K2 "
                        "on every pass of one frame)")
    parser.add_argument("--offpath-only", action="store_true",
                        help="run only the build, the p1024 setup, K4 "
                        "(phase 6a) and K3 on the p1024 lists")
    parser.add_argument("--sessions-only", action="store_true",
                        help="run only the build and phase 4g (three "
                        "frame-coherent sessions at 1920x1088)")
    parser.add_argument("--lod-only", action="store_true",
                        help="run only the build and phase 7 (LOD at the "
                        "4M-Gaussian rung)")
    parser.add_argument("--shards-only", action="store_true",
                        help="run only the build and phase 8 (tile- and "
                        "frame-sharded 1920x1088 frames, shard-drop "
                        "recovery)")
    parser.add_argument("--train-only", action="store_true",
                        help="run only the build and phase 9 (training on "
                        "the card, the trained scene served through K1 "
                        "and K2)")
    parser.add_argument("--serve-only", action="store_true",
                        help="run only the build and phase 10 (the serving "
                        "driver: render mode through K1, the full-width "
                        "qwen1.5-0.5b LM)")
    parser.add_argument("--families-only", action="store_true",
                        help="run only the build and phase 11 (LM serving "
                        "for the MoE/MLA, SSM, hybrid and enc-dec families "
                        "at full width)")
    parser.add_argument("--lm-train-only", action="store_true",
                        help="run only the build and phase 12 (LM training "
                        "at full width, the families card against CPU, "
                        "resume)")
    parser.add_argument("--lm-mesh-only", action="store_true",
                        help="run only the build and phase 13 (the dense "
                        "LM over a mesh of virtual shards of the card)")
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
    if args.passes_only:
        return passes_only(summary, args.json)
    if args.offpath_only:
        return offpath_only(summary, args.json)
    if args.sessions_only:
        return sessions_only(summary, args.json)
    if args.lod_only:
        return lod_only(summary, args.json)
    if args.shards_only:
        return shards_only(summary, args.json)
    if args.train_only:
        return train_only(summary, args.json)
    if args.serve_only:
        return serve_only(summary, args.json)
    if args.families_only:
        return families_only(summary, args.json)
    if args.lm_train_only:
        return lm_train_only(summary, args.json)
    if args.lm_mesh_only:
        return lm_mesh_only(summary, args.json)
    summary["quant"] = timed_phase("quant", phase_quant)

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
    plain_images = summary["serve"].pop("plain_images")
    summary["breakdown"] = phase_breakdown(engine, name)
    plan = engine.plan_for(name, 1088, 1920)
    summary["passes"] = timed_phase(
        "passes", phase_passes, plan, engine.scene(name), cam)
    summary["batch"] = timed_phase("batch", phase_batch, engine, name,
                                   plain_images)
    summary["trace"] = timed_phase("trace", phase_trace, engine, name)
    summary["scheduler"] = timed_phase(
        "scheduler", phase_scheduler, engine, name,
        summary["batch"]["single_wall_s"])
    del engine, plan

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
    del dvs, pt
    torch.cuda.empty_cache()
    engine, name = session_engine()
    summary["sessions"] = timed_phase("sessions", phase_sessions, engine,
                                      name, session_cameras())
    del engine
    torch.cuda.empty_cache()
    summary["lod"] = timed_phase("lod", phase_lod)
    torch.cuda.empty_cache()
    summary["shards"] = timed_phase("shards", phase_shards, plain_images)
    del plain_images
    torch.cuda.empty_cache()
    summary["train"] = timed_phase("train", phase_train)
    torch.cuda.empty_cache()
    summary["driver"] = timed_phase("serve", phase_driver)
    torch.cuda.empty_cache()
    summary["families"] = timed_phase("families", phase_families)
    torch.cuda.empty_cache()
    summary["lm_train"] = timed_phase("lm-train", phase_lm_train)
    torch.cuda.empty_cache()
    summary["lm_mesh"] = timed_phase("lm-mesh", phase_lm_mesh)
    shard_rows = {"prtu_entry_cat_mask": summary["shards"]["kernels"]["k1"],
                  "blend_tiles_fused": summary["shards"]["kernels"]["k2"]}

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
        if kname in shard_rows:
            # Phase 8: the 4-shard frame's launches, and the kernel on one
            # shard's rows.
            kernels[-1].update(
                shard_launches=summary["shards"]["frame"]["launches"][kname],
                shard_ms=shard_rows[kname]["ms"],
                shard_bound_ms=shard_rows[kname]["bound_ms"],
                train_launches=summary["train"]["serve"]["launches"][kname])
        kernels[-1]["lm_mesh_launches"] = summary["lm_mesh"]["launches"][
            kname]
        if kname == "prtu_entry_cat_mask":
            # Phase 10a: the render driver's run.
            kernels[-1].update(driver_launches=summary["driver"]["render"][
                "launches"][kname])
    write_json(args.json, summary)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(ok_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
