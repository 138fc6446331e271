"""RenderEngine: a registry of scenes served frame by frame on one device.

The engine is the request-level layer above the staged render API
(`core.renderer`). It holds named `GaussianScene`s on its device and
renders each request of a batch through the plan specialized to the
scene and the request's resolution:

  scene bucket — scenes are padded to the next power-of-two Gaussian count
                 with inert Gaussians (`core.gaussians.pad_scene`: opacity
                 below the 1/255 blend threshold, culled for every camera);
  k_max        — per-scene list capacity, given or measured from a camera
                 probe set at registration (`probe_cameras=`): the longest
                 Stage-1 survivor list over the probes, pow2-bucketed.

SPILL serving: with `OverflowPolicy.SPILL` the plan's k_max is the per-pass
streaming chunk and the engine derives the pass count per scene, rounded up
to a power of two. A frame that still exhausts its spill capacity (off-probe
traffic) is re-rendered with a doubled pass bucket, which sticks for the
scene, so SPILL frames never report `FrameResult.overflow`.

The engine runs on `torch.device("cuda")` unless it is given another
device, and raises if CUDA is asked for and absent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import torch

from repro_torch.core.camera import Camera
from repro_torch.core.gaussians import GaussianScene, pad_scene
from repro_torch.core.renderer import (OverflowPolicy, RenderPlan, Renderer,
                                       enforce_overflow_policy, measure_k_max,
                                       next_pow2)


def scene_bucket(n: int) -> int:
    """Gaussian-count bucket a scene is padded to."""
    return next_pow2(n)


@dataclasses.dataclass(frozen=True)
class RenderRequest:
    """One camera pose against one registered scene."""
    scene: str
    camera: Camera
    request_id: int = -1


@dataclasses.dataclass(frozen=True)
class FrameResult:
    """Per-request render output."""
    request: RenderRequest
    image: torch.Tensor       # (H, W, 3) on the engine's device
    alpha: torch.Tensor       # (H, W)
    counters: dict            # 0-d tensors for this frame
    render_s: float           # wall-clock of this frame, device-synced
    passes_run: int           # spill passes rendered, retries included
    overflow: bool = False    # this frame's Stage-1 lists were clamped


@dataclasses.dataclass(frozen=True)
class _SceneEntry:
    scene: GaussianScene      # padded to `n_bucket`, on the engine device
    n_real: int
    n_bucket: int
    k_max: int


def _resolve_device(device) -> torch.device:
    """The device to serve on; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the engine was asked for CUDA but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to serve on the CPU")
    return device


class RenderEngine:
    """Registry of scenes + per-frame renderer.

    base: the render configuration to serve with — a `Renderer` or a
        `RenderPlan`. Its grid resolution and k_max are overridden per
        (request resolution, scene) at render time.
    device: where scenes live and frames render (default "cuda").
    overflow: the OverflowPolicy applied per frame. None keeps the base
        plan's policy, except that the core default CLAMP is upgraded to
        WARN: serving traffic should never clamp silently.
    dataflow: when not None, overrides the plan's dataflow: "stream" (the
        survivor-stream path, O(tiles·k_max) CAT memory, the only one that
        fits production scene sizes) or "dense" (the O(regions·N) parity
        oracle).
    """

    def __init__(self, base: Union[Renderer, RenderPlan, None] = None, *,
                 device: Union[str, torch.device] = "cuda",
                 overflow: Union[OverflowPolicy, str, None] = None,
                 dataflow: Optional[str] = None):
        plan = (RenderPlan() if base is None else
                base.plan if isinstance(base, Renderer) else base)
        if dataflow is not None:
            plan = dataclasses.replace(plan, dataflow=dataflow)
        if overflow is None and plan.stream.overflow is OverflowPolicy.CLAMP:
            overflow = OverflowPolicy.WARN
        if overflow is not None:
            plan = dataclasses.replace(
                plan, stream=dataclasses.replace(
                    plan.stream, overflow=OverflowPolicy(overflow)))
        self.plan = plan
        self.device = _resolve_device(device)
        self._scenes: dict[str, _SceneEntry] = {}
        # Per-scene learned multiplier on the spill pass bucket: doubled
        # whenever a SPILL frame exhausts its capacity.
        self._spill_boost: dict[str, int] = {}
        self.spill_retries = 0

    def register_scene(self, name: str, scene: GaussianScene, *,
                       k_max: Optional[int] = None,
                       probe_cameras: Optional[Sequence[Camera]] = None
                       ) -> _SceneEntry:
        """Register (and bucket-pad) a scene under `name`, on the engine's
        device. k_max: per-tile list capacity; when None it is measured
        over `probe_cameras` if given (`core.renderer.measure_k_max`,
        capped at the scene bucket), else the padded Gaussian count."""
        n_real = scene.n
        n_bucket = scene_bucket(n_real)
        padded = pad_scene(scene.to(self.device), n_bucket)
        if k_max is None and probe_cameras is not None:
            # Padding is inert and culled, so it never lengthens a list.
            k_max = measure_k_max(
                padded, [c.to(self.device) for c in probe_cameras],
                grid=self.plan.grid, cap=n_bucket)
        entry = _SceneEntry(scene=padded, n_real=n_real, n_bucket=n_bucket,
                            k_max=k_max if k_max is not None else n_bucket)
        self._scenes[name] = entry
        return entry

    def scene(self, name: str) -> GaussianScene:
        """The registered (padded, on-device) scene."""
        return self._scenes[name].scene

    def scene_names(self) -> list[str]:
        return list(self._scenes)

    def plan_for(self, name: str, height: int, width: int) -> RenderPlan:
        """The engine plan specialized to a scene's k_max and a resolution.

        Non-SPILL policies serve at the scene's k_max. SPILL keeps the
        plan's k_max as the per-pass chunk and sizes the pass count to the
        scene: next_pow2(ceil(scene k_max / chunk)), times any learned
        overflow boost, capped at the count that covers every Gaussian."""
        entry = self._scenes[name]
        stream = self.plan.stream
        if stream.overflow is OverflowPolicy.SPILL:
            k_pass = min(stream.k_max, entry.k_max)
            if entry.k_max < entry.n_bucket:
                need = next_pow2(-(-entry.k_max // k_pass))
            else:
                # Unmeasured bound: start from the base plan's pass budget;
                # overflow retries double it.
                need = next_pow2(stream.max_spill_passes)
            passes = need * self._spill_boost.get(name, 1)
            passes = min(passes, next_pow2(-(-entry.n_bucket // k_pass)))
            stream = dataclasses.replace(stream, k_max=k_pass,
                                         max_spill_passes=passes)
        else:
            stream = dataclasses.replace(stream, k_max=entry.k_max)
        return dataclasses.replace(
            self.plan, grid=self.plan.grid.with_resolution(height, width),
            stream=stream)

    def render_batch(self, requests: Sequence[RenderRequest]
                     ) -> list[FrameResult]:
        """Render a homogeneous batch (one scene, one resolution), one frame
        after another, results in request order."""
        requests = list(requests)
        if not requests:
            return []
        names = {r.scene for r in requests}
        if len(names) != 1:
            raise ValueError(f"mixed scenes in one batch: {sorted(names)}")
        name = requests[0].scene
        if name not in self._scenes:
            raise KeyError(f"scene {name!r} not registered "
                           f"(have {self.scene_names()})")
        res = {(r.camera.height, r.camera.width) for r in requests}
        if len(res) != 1:
            raise ValueError(f"mixed resolutions in one batch: {sorted(res)}")
        (height, width), = res
        return [self._render_one(r, name, height, width) for r in requests]

    def _render_one(self, request: RenderRequest, name: str, height: int,
                    width: int) -> FrameResult:
        entry = self._scenes[name]
        camera = request.camera.to(self.device)
        passes_run = 0
        t0 = time.perf_counter()
        while True:
            plan = self.plan_for(name, height, width)
            out, counters = plan.render_with_stats(entry.scene, camera,
                                                   enforce=False)
            passes_run += plan.n_passes
            overflow = bool(out.overflow)
            capacity = plan.stream.k_max * plan.n_passes
            if (overflow and plan.stream.overflow is OverflowPolicy.SPILL
                    and capacity < entry.n_bucket):
                # Off-probe traffic exhausted the spill capacity: double the
                # scene's pass bucket (it sticks) and re-render.
                self._spill_boost[name] = 2 * self._spill_boost.get(name, 1)
                self.spill_retries += 1
                continue
            break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        counters = dict(counters)
        # Report the real Gaussian count, not the padded bucket.
        counters["n_gaussians"] = torch.tensor(float(entry.n_real),
                                               device=self.device)
        if overflow:
            enforce_overflow_policy(
                True, plan.stream.overflow, k_max=plan.stream.k_max,
                n_passes=plan.n_passes,
                context=f"scene {name!r} at {height}x{width}")
        return FrameResult(request=request, image=out.image, alpha=out.alpha,
                           counters=counters,
                           render_s=dt, passes_run=passes_run,
                           overflow=overflow)
