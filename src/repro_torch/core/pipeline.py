"""Legacy flat-config entry points for the staged render pipeline.

The render API lives in `core.renderer`: structured per-stage configs
assembled by a `Renderer` facade into a `RenderPlan`. This module keeps the
reference's original flat surface as thin shims:

* `RenderConfig` — the flat dataclass of orthogonal knobs; `to_plan()` /
  `to_renderer()` map it onto the structured configs (`use_cuda` →
  `TestConfig.backend="cuda"`, `fused` → `RasterConfig.fused`, `dataflow`
  → `RenderPlan.dataflow`), and `from_plan()` maps back.
* `render` / `render_with_stats` — deprecated module-level entry points.
  They warn with `DeprecationWarning` and delegate to the equivalent plan,
  whose image and counters they return unchanged.
* `FLICKER_CONFIG`, `VANILLA_CONFIG` (vanilla 3DGS, tile AABB) and
  `GSCORE_CONFIG` (GSCore, sub-tile OBB): the paper's method and its two
  baselines.

Prefer::

    from repro_torch.core import Renderer, TestConfig, RasterConfig
    r = Renderer(test=TestConfig(method="cat"), raster=RasterConfig(fused=True))
    out, counters = r.render_with_stats(scene, camera)
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.gaussians import GaussianScene
from repro_torch.core.culling import TileGrid
from repro_torch.core.cat import SamplingMode
from repro_torch.core import raster
from repro_torch.core.precision import PrecisionScheme, FULL_FP32, MIXED
from repro_torch.core.renderer import (Renderer, RenderPlan, GridConfig,
                                       TestConfig, StreamConfig, RasterConfig,
                                       cat_mask_elems)
from repro_torch.core.metrics import psnr

__all__ = [
    "RenderConfig", "FLICKER_CONFIG", "VANILLA_CONFIG", "GSCORE_CONFIG",
    "render", "render_with_stats", "cat_mask_elems", "psnr",
]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Legacy flat render config (see the module docstring for the API)."""
    height: int = 128
    width: int = 128
    tile: int = 16
    subtile: int = 8
    minitile: int = 4
    method: str = "cat"                       # aabb | obb | cat
    dataflow: str = "stream"                  # stream | dense ('cat' only)
    mode: SamplingMode = SamplingMode.SMOOTH_FOCUSED
    precision: PrecisionScheme = MIXED
    k_max: int = 1024
    spiky_threshold: float = 3.0
    background: float = 0.0
    use_cuda: bool = False                    # -> TestConfig.backend="cuda"
    fused: bool = False                       # -> RasterConfig.fused

    def grid(self) -> TileGrid:
        return TileGrid(self.height, self.width, self.tile, self.subtile,
                        self.minitile)

    def to_plan(self) -> RenderPlan:
        """The equivalent staged `RenderPlan`."""
        return RenderPlan(
            grid=GridConfig(self.height, self.width, self.tile,
                            self.subtile, self.minitile),
            test=TestConfig(method=self.method, mode=self.mode,
                            precision=self.precision,
                            spiky_threshold=self.spiky_threshold,
                            backend="cuda" if self.use_cuda else "torch"),
            stream=StreamConfig(k_max=self.k_max),
            raster=RasterConfig(background=self.background,
                                fused=self.fused),
            dataflow=self.dataflow)

    def to_renderer(self) -> Renderer:
        return Renderer.from_plan(self.to_plan())

    @classmethod
    def from_plan(cls, plan: RenderPlan) -> "RenderConfig":
        """Inverse of `to_plan`, lossy only in the overflow policy and its
        spill pass count, which the flat config never had (it clamps)."""
        return cls(
            height=plan.grid.height, width=plan.grid.width,
            tile=plan.grid.tile, subtile=plan.grid.subtile,
            minitile=plan.grid.minitile,
            method=plan.test.method, dataflow=plan.dataflow,
            mode=plan.test.mode, precision=plan.test.precision,
            k_max=plan.stream.k_max,
            spiky_threshold=plan.test.spiky_threshold,
            background=plan.raster.background,
            use_cuda=plan.test.backend == "cuda",
            fused=plan.raster.fused)


FLICKER_CONFIG = RenderConfig(method="cat", mode=SamplingMode.SMOOTH_FOCUSED,
                              precision=MIXED)
VANILLA_CONFIG = RenderConfig(method="aabb", precision=FULL_FP32)
GSCORE_CONFIG = RenderConfig(method="obb", precision=FULL_FP32)


def _warn_deprecated(name: str):
    warnings.warn(
        f"core.pipeline.{name} is deprecated; build a core.Renderer "
        f"(or RenderConfig.to_renderer()) and call its {name} method "
        f"instead", DeprecationWarning, stacklevel=3)


def render(scene: GaussianScene, camera,
           cfg: RenderConfig) -> raster.RenderOut:
    """Deprecated: use `Renderer.render`."""
    _warn_deprecated("render")
    return cfg.to_plan().render(scene, camera)


def render_with_stats(scene: GaussianScene, camera, cfg: RenderConfig):
    """Deprecated: use `Renderer.render_with_stats`. Returns (RenderOut,
    counters dict), those of the equivalent `cfg.to_plan()`."""
    _warn_deprecated("render_with_stats")
    return cfg.to_plan().render_with_stats(scene, camera)
