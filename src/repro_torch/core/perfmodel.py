"""Analytical performance / energy / area model of FLICKER (paper §V).

The paper evaluates a cycle-accurate simulator of an ASIC we cannot run; this
module is the explicit machine model that reproduces the paper's evaluation
axes (speed, energy, area) from *real workload counters* measured by the
render pipeline (core.hierarchy / core.renderer counters). It models the
FLICKER ASIC, not the GPU the port runs on: its FPS is the accelerator's,
never the card's. It is a copy of the reference's model (same constants,
same functions), so one frame's counters give the same outputs in both
packages.

    blend ops   — pixel-Gaussian blends the VRUs execute (incl. early-term)
    ctu_prs     — pixel-rectangles the CTU evaluates (adaptive-mode weighted)
    preproc     — Gaussians projected / AABB-tested by the preprocessing core
    sort        — Gaussian instances sorted
    dram bytes  — geometric/color feature traffic (clustering-aware)

With the fused raster path (`RasterConfig(fused=True)`) the blend/termination
counters are *measured by the kernel that does the work* rather than
modeled after the fact: `processed_per_pixel` (-> blend_ops below) and
`entry_alive` (-> the `*_eff` CTU counters) come out of
`kernels.render.blend_tiles_fused`. The fused-only `swept_per_pixel`
counter (list slots swept after early termination) describes the GPU
kernel's work, not the modeled ASIC's, so it is deliberately not a model
input — serving telemetry surfaces it directly.

The counters are dataflow-agnostic: the stream pipeline (the default,
`RenderPlan(dataflow="stream")`) reproduces every key the dense oracle
emits, entry-for-entry, so nothing here depends on which dataflow measured
the workload. The one stream-specific counter, `cat_mask_bytes` (the
CAT-stage mask footprint; see `renderer.cat_mask_elems`), is a memory
proxy of the software pipeline itself, not an ASIC quantity —
`cat_stage_bytes` below surfaces it.

Machine configurations mirror §V-A: FLICKER = 4 rendering cores × (4×2) VRUs
(32 VRUs) + 4 CTUs (2 PRs/cycle each) + 4 sorting units + 4 preprocessing
cores @ 1 GHz, LPDDR4 51.2 GB/s; GSCore = 64 VRUs + OBB, no CTU; the
"simplified" baseline = FLICKER minus the CTU. Energy/area constants are
representative 28 nm values (sources in comments); they are *calibration
constants of the model*, the workload numbers are measured.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Hardware configurations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HwConfig:
    name: str
    n_vru: int = 32                 # pixel-blend units (1 blend/cycle each)
    n_ctu: int = 4                  # CTUs, each 2 PRTUs -> 2 PRs/cycle
    n_preproc: int = 4              # Gaussians/cycle (1 per core, pipelined)
    n_sort: int = 4                 # sorted elements/cycle
    freq_hz: float = 1.0e9
    dram_gbps: float = 51.2         # LPDDR4
    fifo_depth: int = 16            # per-mini-tile feature FIFO entries
    fifo_width_bytes: int = 48      # one Gaussian record (mean, conic, o, rgb)
    has_ctu: bool = True
    ctu_precision: str = "mixed"    # mixed | fp16


FLICKER_HW = HwConfig("flicker")
FLICKER_NO_CTU = HwConfig("flicker-noctu", has_ctu=False)
GSCORE_HW = HwConfig("gscore", n_vru=64, has_ctu=False)
# 64-VRU variant of the simplified design (Tbl. II(b) baseline).
BASELINE_64VRU = HwConfig("baseline-64vru", n_vru=64, has_ctu=False)


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    """Edge-GPU (Jetson Xavier NX) roofline-style model. The paper profiles
    29% achieved FP32 (Fig. 1b) — divergence waste — which we apply as the
    utilization of peak. Power counts the GPU rail only (~5 W of the 10 W
    module budget), chip-vs-chip like the paper's comparison."""
    name: str = "xnx"
    peak_fp32: float = 1.1e12       # XNX ~1.1 TFLOP/s FP32 (384-core Volta)
    fp_util: float = 0.29           # Fig. 1(b)
    board_power_w: float = 2.5      # GPU rail at ~29% utilization


XNX_GPU = GpuConfig()

# ---------------------------------------------------------------------------
# Energy / area calibration constants (28 nm)
# ---------------------------------------------------------------------------
# Per-op energies, pJ. Representative values: Horowitz ISSCC'14 scaled to
# 28 nm; DRAM from [22][24] (LPDDR4 ~15-25 pJ/byte incl. PHY).
E_BLEND_PJ = 18.0          # one pixel-Gaussian blend (exp, 2 FMA, regs, FP16)
E_PR_MIXED_PJ = 7.0        # one PR (4 leaders) in FP16-delta/FP8-accum
E_PR_FP16_PJ = 12.0        # full-FP16 PRTU
E_PREPROC_PJ = 220.0       # project+cov+AABB per Gaussian (FP32, ~150 flops)
E_SORT_PJ = 6.0            # per element per pass (bitonic stage, SRAM r/w)
E_SRAM_PJ_B = 1.0          # on-chip buffer access per byte
E_DRAM_PJ_B = 20.0         # LPDDR4 per byte
P_STATIC_W = 0.15          # leakage + clock tree for the whole chip

# Areas, mm^2 at 28 nm.
A_VRU = 0.040              # one VRU (FP16 blend datapath + regs)
A_CTU_MIXED = 0.024        # one CTU (2 mixed-precision PRTUs + MMU + ctrl)
A_CTU_FP16 = 0.040
A_PREPROC = 0.360          # preprocessing core (FP32 proj/cov datapath)
A_SORT = 0.210             # sorting unit
A_SRAM_PER_KB = 0.0040     # memory-compiler SRAM
FIXED_SRAM_KB = 640.0      # feature buffers, tile buffers, frame slice


# ---------------------------------------------------------------------------
# Workload descriptor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Workload:
    """Per-frame counters, produced by the render pipeline."""
    blend_ops: float            # pixel-Gaussian blends executed by VRUs
    ctu_prs: float              # PRs evaluated by CTUs (0 if no CTU)
    preproc_gaussians: float    # Gaussians through the preprocessing core
    sort_elems: float           # instances sorted (dup count at tile level)
    dram_bytes: float           # off-chip traffic
    pixels: float               # image pixels (for per-pixel normalization)
    vru_imbalance: float = 1.0  # Σ_t max-unit-work / Σ_t mean-unit-work —
    #                             lockstep units (mini-tile channels for
    #                             FLICKER, sub-tile groups for GSCore) sync at
    #                             tile boundaries; the busiest unit gates the
    #                             tile. 1.0 = perfectly balanced.

    @staticmethod
    def from_counters(counters: dict, *, height: int, width: int,
                      dram_bytes: float | None = None) -> "Workload":
        c = {k: float(v) for k, v in counters.items()}
        # blend_ops comes from processed_per_pixel — kernel-measured on the
        # fused raster path, modeled (same accounting) on the jnp path.
        blend = c.get("processed_per_pixel", 0.0) * height * width
        n = c.get("n_gaussians", 0.0)
        # Prefer termination-aware effective CTU counts when available.
        ctu_prs = c.get("ctu_prs_eff", c.get("ctu_prs", 0.0))
        # Default traffic: geometric (20 B) for all + color (90 B) for
        # tile-intersecting instances, fp16 params.
        if dram_bytes is None:
            dram_bytes = n * 20.0 + c.get("dup_tile", 0.0) * 90.0
        return Workload(
            blend_ops=blend,
            ctu_prs=ctu_prs,
            preproc_gaussians=c.get("n_gaussians", 0.0),
            sort_elems=c.get("dup_tile", 0.0),
            dram_bytes=dram_bytes,
            pixels=float(height * width),
        )


def cat_stage_bytes(counters: dict) -> float:
    """CAT-stage mask footprint (bytes) the pipeline recorded for the frame
    (`cat_mask_bytes`; 0.0 for baseline methods that emit no CAT mask).
    Memory proxy of the software pipeline — the quantity that differs
    across dataflows — not an ASIC term."""
    return float(counters.get("cat_mask_bytes", 0.0))


# ---------------------------------------------------------------------------
# Timing model
# ---------------------------------------------------------------------------

# FIFO smoothing model (Fig. 9). Lockstep render units sync at tile
# boundaries, so the busiest unit gates each tile (w.vru_imbalance ≥ 1).
# FLICKER's per-mini-tile feature FIFOs let channels run ahead across the
# sync point: depth d absorbs a fraction d/(d+K_BURST) of the imbalance.
# K_BURST calibrated so depth 16 recovers ~96% of the depth-128 speedup
# (paper §V-B) given a typical imbalance of ~2x.
K_BURST = 0.70


def effective_imbalance(imb: float, fifo_depth: int) -> float:
    return 1.0 + (imb - 1.0) * K_BURST / (fifo_depth + K_BURST)


def render_time_s(w: Workload, hw: HwConfig) -> float:
    """Rendering-stage latency (the paper's Fig. 8/9 scope)."""
    vru_cycles = w.blend_ops / hw.n_vru
    if hw.has_ctu:
        # FIFOs smooth the mini-tile load imbalance.
        vru_cycles *= effective_imbalance(w.vru_imbalance, hw.fifo_depth)
        ctu_cycles = w.ctu_prs / (2.0 * hw.n_ctu)
    else:
        # No FIFOs: the full lockstep imbalance applies.
        vru_cycles *= w.vru_imbalance
        ctu_cycles = 0.0
    # CTU overlaps VRU work (stall-resilient pipeline): stage time is the max.
    cycles = max(vru_cycles, ctu_cycles)
    return cycles / hw.freq_hz


def frame_time_s(w: Workload, hw: HwConfig) -> dict:
    """Full-frame latency: preprocess, sort, render, DRAM — pipelined, so the
    frame time is the max stage time (plus nothing: deep frame-level
    pipelining, as in GSCore)."""
    t_pre = w.preproc_gaussians / hw.n_preproc / hw.freq_hz
    # Sorting: two-pass bucketed radix/merge at 4 elements/cycle per unit
    # (GSCore-style dedicated sorter; depth keys are 16-bit).
    t_sort = w.sort_elems * 2.0 / (hw.n_sort * 4.0) / hw.freq_hz
    t_render = render_time_s(w, hw)
    t_dram = w.dram_bytes / (hw.dram_gbps * 1e9)
    t_frame = max(t_pre, t_sort, t_render, t_dram)
    return dict(t_pre=t_pre, t_sort=t_sort, t_render=t_render,
                t_dram=t_dram, t_frame=t_frame, fps=1.0 / t_frame)


def ctu_stall_rate(w: Workload, hw: HwConfig) -> float:
    """Fraction of CTU-active cycles spent stalled on full FIFOs (Fig. 9).

    The CTU stalls when the busiest channel's FIFO backs up; shallow FIFOs
    back up for the entire residual-imbalance window."""
    if not hw.has_ctu or w.ctu_prs == 0:
        return 0.0
    vru_cycles = (w.blend_ops / hw.n_vru
                  * effective_imbalance(w.vru_imbalance, hw.fifo_depth))
    ctu_cycles = w.ctu_prs / (2.0 * hw.n_ctu)
    if ctu_cycles >= vru_cycles:
        return 0.0  # CTU is the bottleneck; FIFOs run empty, never full.
    slack = 1.0 - ctu_cycles / vru_cycles
    # Residual imbalance not absorbed by the FIFOs shows up as stalls.
    resid = (effective_imbalance(w.vru_imbalance, hw.fifo_depth) - 1.0) \
        / max(w.vru_imbalance - 1.0, 1e-9)
    return min(1.0, slack * (0.3 + 0.7 * resid))


# ---------------------------------------------------------------------------
# Energy model
# ---------------------------------------------------------------------------


def energy_j(w: Workload, hw: HwConfig) -> dict:
    e_pr = E_PR_MIXED_PJ if hw.ctu_precision == "mixed" else E_PR_FP16_PJ
    e = dict(
        blend=w.blend_ops * E_BLEND_PJ,
        ctu=(w.ctu_prs * e_pr) if hw.has_ctu else 0.0,
        preproc=w.preproc_gaussians * E_PREPROC_PJ,
        sort=w.sort_elems * E_SORT_PJ * 4.0,
        sram=(w.blend_ops * hw.fifo_width_bytes / 16.0) * E_SRAM_PJ_B,
        dram=w.dram_bytes * E_DRAM_PJ_B,
    )
    total_dyn = sum(e.values()) * 1e-12
    t = frame_time_s(w, hw)["t_frame"]
    e_static = P_STATIC_W * t
    return dict(**{k: v * 1e-12 for k, v in e.items()},
                static=e_static, total=total_dyn + e_static)


def render_energy_j(w: Workload, hw: HwConfig) -> dict:
    """Rendering-stage energy only (paper Fig. 8(b) scope): VRU blends, CTU
    tests, feature-FIFO SRAM traffic, and static power over the stage time."""
    e_pr = E_PR_MIXED_PJ if hw.ctu_precision == "mixed" else E_PR_FP16_PJ
    e = dict(
        blend=w.blend_ops * E_BLEND_PJ,
        ctu=(w.ctu_prs * e_pr) if hw.has_ctu else 0.0,
        sram=(w.blend_ops * hw.fifo_width_bytes / 16.0) * E_SRAM_PJ_B,
    )
    total_dyn = sum(e.values()) * 1e-12
    e_static = P_STATIC_W * render_time_s(w, hw)
    return dict(**{k: v * 1e-12 for k, v in e.items()},
                static=e_static, total=total_dyn + e_static)


def gpu_frame(w: Workload, gpu: GpuConfig, flops_per_blend: float = 16.0,
              render_frac: float = 0.6):
    """Edge-GPU reference. The CUDA rasterizer spends ~26 FLOPs per
    pixel-Gaussian blend (conic eval + exp + blend + addressing), and the
    rendering kernel is ~60% of frame time [7][17][18] — the rest
    (preprocess/sort) scales it up. Energy = GPU-rail power × time."""
    t = w.blend_ops * flops_per_blend / (gpu.peak_fp32 * gpu.fp_util)
    t = t / render_frac
    return dict(t_frame=t, fps=1.0 / t, energy=t * gpu.board_power_w)


# ---------------------------------------------------------------------------
# Area model (Tbl. II)
# ---------------------------------------------------------------------------


def area_mm2(hw: HwConfig) -> dict:
    a_ctu = (A_CTU_MIXED if hw.ctu_precision == "mixed" else A_CTU_FP16)
    n_fifo = (hw.n_vru // 2)  # one FIFO drives two VRUs (Fig. 6)
    fifo_kb = n_fifo * hw.fifo_depth * hw.fifo_width_bytes / 1024.0
    parts = dict(
        vru=hw.n_vru * A_VRU,
        ctu=hw.n_ctu * a_ctu if hw.has_ctu else 0.0,
        preproc=hw.n_preproc * A_PREPROC,
        sort=hw.n_sort * A_SORT,
        fifo=(fifo_kb * A_SRAM_PER_KB) if hw.has_ctu else 0.0,
        sram=FIXED_SRAM_KB * A_SRAM_PER_KB,
    )
    parts["total"] = sum(parts.values())
    return parts
