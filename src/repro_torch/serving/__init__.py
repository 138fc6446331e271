"""Request-level serving on one device or a mesh, above the staged render
API.

    engine     — RenderEngine: scene registry (probe-driven k_max) +
                 RenderPlan-keyed plan cache + batched rendering (one K1
                 and one K2 launch per pass for a batch) + per-batch
                 OverflowPolicy enforcement + sticky frame-coherent
                 sessions (`incremental=True`, `RenderRequest.session`)
    scheduler  — deadline-aware continuous batching: priority tiers +
                 EDF dispatch, EWMA wall prediction, admission control
                 with resolution-fallback degrade / reject
    batching   — MicroBatcher compat shim over the scheduler
    telemetry  — rolling latency percentiles, throughput, overflow/spill
                 accounting, per-tier SLO counters, and the modeled
                 FLICKER ASIC FPS from the frames' counters
    sharding   — frame-axis and tile-axis device sharding over a
                 `distributed.sharding.Mesh` of torch devices (tile_mesh,
                 shard_frames, replicate)
    workloads  — demo scenes, the Full-HD (1920×1088 / 512k) SPILL
                 workload and its frame-size-aware batching policy, and
                 the replayable open-loop traffic generator
"""
from repro_torch.serving.engine import (FrameResult, RenderEngine,
                                        RenderRequest, batch_bucket,
                                        scene_bucket)
from repro_torch.serving.scheduler import (AdmissionRejected, RequestResult,
                                           Scheduler, Tier)
from repro_torch.serving.batching import MicroBatcher
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.workloads import (HD1080_GAUSSIANS, HD1080_HEIGHT,
                                           HD1080_WIDTH, HD_SCENE_KW, Arrival,
                                           hd1080_cameras, hd1080_engine,
                                           max_batch_for, open_loop_trace,
                                           register_demo_scenes,
                                           register_hd1080_scene,
                                           replay_open_loop,
                                           trace_fingerprint)
from repro_torch.core.renderer import (OverflowPolicy, StreamOverflowError,
                                       StreamOverflowWarning, measure_k_max)

__all__ = [
    "RenderEngine", "RenderRequest", "FrameResult", "batch_bucket",
    "scene_bucket", "Scheduler", "Tier", "AdmissionRejected",
    "MicroBatcher", "RequestResult", "Telemetry",
    "HD1080_GAUSSIANS", "HD1080_HEIGHT", "HD1080_WIDTH", "HD_SCENE_KW",
    "register_demo_scenes", "max_batch_for", "hd1080_cameras",
    "hd1080_engine", "register_hd1080_scene", "Arrival", "open_loop_trace",
    "trace_fingerprint", "replay_open_loop", "OverflowPolicy",
    "StreamOverflowWarning", "StreamOverflowError", "measure_k_max",
]
