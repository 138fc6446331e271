"""The tile blend kernels — the VRU array: K2 (fused) and K3 (full sweep).

`blend_tiles_fused` (K2) blends each tile's compacted, depth-ordered list front
to back with the paper's two in-loop skipping decisions: a per-tile bound
on occupied K_BLK chunks, and tile-level early termination once every
pixel's transmittance is below T_EPS. It resumes from carried state
(`init`) so consecutive spill passes chain exactly, and it reports the work
it measured (processed/blended per pixel, entry_alive per entry,
kblocks_processed per tile).

On CUDA tensors it launches the hand-written Hopper kernel
`csrc/blend_fused.cu`; on CPU tensors it runs `blend_tiles_fused_plain`,
the same chunked front-to-back fold in PyTorch.

`blend_tiles` (K3) is the full sweep the fused kernel is measured against:
every slot of every tile, no termination, no counters, returning (rgb,
trans). On CUDA tensors it launches `csrc/blend_full.cu`; on CPU tensors
it runs `blend_tiles_plain`, the same front-to-back fold in PyTorch.

Operands (pre-gathered per tile, see `kernels.ops.gather_tile_features`):
    pix    (T, P, 2)   pixel centers, P = 256
    feat   (T, K, 8)   [mean_x, mean_y, cxx, cxy, cyy, opacity, 0, 0]
    colors (T, K, 3)
    valid  (T, K)      int8 list slot occupied
    allow  (T, K, Mt)  int8 per-entry CAT mask over the tile's mini-tiles
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.gaussians import ALPHA_MIN
from repro_torch.core.raster import ALPHA_MAX, T_EPS, entry_alpha
from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand as check

K_BLK = 128
PIXELS = 256            # the kernel's pixels per tile (16x16)
MINITILES = 16

launches = 0            # K2 launches since the last reset to 0
full_launches = 0       # K3 launches since the last reset to 0


class FusedBlendOut(NamedTuple):
    rgb: torch.Tensor                # (T, P, 3) blended color
    trans: torch.Tensor              # (T, P) transmittance at termination
    processed: torch.Tensor          # (T, P) f32 Gaussians touched alive
    blended: torch.Tensor            # (T, P) f32 Gaussians actually blended
    entry_alive: torch.Tensor        # (T, K) bool entry seen pre-termination
    kblocks_processed: torch.Tensor  # (T,) i32 K blocks the kernel ran
    kblocks_total: int               # K blocks a full sweep would run


def pixel_minitile_index(p: int, mt: int, device="cpu") -> torch.Tensor:
    """(P,) tile-local mini-tile index of each tile pixel (row-major), from
    shapes alone: tile = √P and minitile = tile/√Mt."""
    tile = int(round(p ** 0.5))
    mtx = int(round(mt ** 0.5))
    m = tile // mtx
    r = torch.arange(tile, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return ((dy // m) * mtx + (dx // m)).reshape(-1)


def kblock_bound_of(valid: torch.Tensor) -> torch.Tensor:
    """(T,) int32 occupied K_BLK chunks per tile: valid entries are a
    prefix of each compacted list, so this is ceil(popcount / K_BLK)."""
    nvalid = (valid != 0).sum(dim=1)
    return torch.div(nvalid + K_BLK - 1, K_BLK,
                     rounding_mode="floor").to(torch.int32)


def blend_tiles_fused_plain(pix, feat, colors, valid, allow, kblock_bound,
                            t0, acc0, p0, b0):
    """Plain PyTorch version of the kernel: the same chunk schedule (a tile
    runs chunk j iff j < its bound and some pixel has T >= T_EPS entering
    it, and stops at the first chunk that does not run) and the same
    per-entry fold as `core.raster.blend_pass`. Returns FusedBlendOut."""
    t, p, _ = pix.shape
    k = feat.shape[1]
    mt_idx = pixel_minitile_index(p, allow.shape[2], pix.device)
    trans, rgb, proc, blnd = t0.clone(), acc0.clone(), p0.clone(), b0.clone()
    valid_b = valid != 0
    alive_out = torch.zeros((t, k), dtype=torch.bool, device=pix.device)
    kproc = torch.zeros((t,), dtype=torch.int32, device=pix.device)
    running = torch.ones((t,), dtype=torch.bool, device=pix.device)
    n_blocks = -(-k // K_BLK)
    for j in range(n_blocks):
        running = running & (j < kblock_bound) & (trans >= T_EPS).any(dim=1)
        kproc += running.to(torch.int32)
        run = running[:, None]
        for kk in range(j * K_BLK, min(k, (j + 1) * K_BLK)):
            lane = valid_b[:, kk, None] & (allow[:, kk][:, mt_idx] != 0)
            a = entry_alpha(pix, feat[:, kk, 0:2], feat[:, kk, 2:5],
                            feat[:, kk, 5], lane)
            alive = trans >= T_EPS
            w = trans * a
            rgb = torch.where(run[..., None],
                              rgb + w[..., None] * colors[:, kk, None, :],
                              rgb)
            proc = torch.where(run, proc + (lane & alive), proc)
            blnd = torch.where(run, blnd + ((a > 0) & alive), blnd)
            alive_out[:, kk] = alive.any(dim=1) & valid_b[:, kk] & running
            trans = torch.where(run, trans * (1.0 - a), trans)
    return FusedBlendOut(rgb=rgb, trans=trans, processed=proc, blended=blnd,
                         entry_alive=alive_out, kblocks_processed=kproc,
                         kblocks_total=n_blocks)


def blend_tiles_fused(pix: torch.Tensor, feat: torch.Tensor,
                      colors: torch.Tensor, valid: torch.Tensor,
                      allow: torch.Tensor,
                      kblock_bound: Optional[torch.Tensor] = None,
                      init: Optional[tuple] = None) -> FusedBlendOut:
    """Contribution-aware blend with in-kernel early termination.

    kblock_bound: optional (T,) int32 occupied K_BLK chunks per tile
    (`kblock_bound_of(valid)` when None). init: optional carried state
    (trans (T,P), rgb (T,P,3), processed (T,P), blended (T,P)) from the
    previous spill pass; chaining calls over consecutive list segments
    equals one call over the concatenation when the segment lengths are
    multiples of K_BLK. Image and transmittance match the full sweep to
    < T_EPS; the counters follow the reference accounting exactly.
    """
    t, p, _ = pix.shape
    k = feat.shape[1]
    dev = pix.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if kblock_bound is None:
        kblock_bound = kblock_bound_of(valid)
    if init is None:
        f32 = dict(dtype=torch.float32, device=dev)
        init = (torch.ones((t, p), **f32), torch.zeros((t, p, 3), **f32),
                torch.zeros((t, p), **f32), torch.zeros((t, p), **f32))
    t0, acc0, p0, b0 = init
    if dev.type == "cpu":
        return blend_tiles_fused_plain(pix, feat, colors, valid, allow,
                                       kblock_bound, t0, acc0, p0, b0)
    f32, i8 = torch.float32, torch.int8
    check("pix", pix, f32, (t, PIXELS, 2), dev)
    check("feat", feat, f32, (t, k, 8), dev)
    check("colors", colors, f32, (t, k, 3), dev)
    check("valid", valid, i8, (t, k), dev)
    check("allow", allow, i8, (t, k, MINITILES), dev)
    check("kblock_bound", kblock_bound, torch.int32, (t,), dev)
    check("t0", t0, f32, (t, PIXELS), dev)
    check("acc0", acc0, f32, (t, PIXELS, 3), dev)
    check("p0", p0, f32, (t, PIXELS), dev)
    check("b0", b0, f32, (t, PIXELS), dev)
    rgb = torch.empty((t, p, 3), dtype=f32, device=dev)
    trans = torch.empty((t, p), dtype=f32, device=dev)
    proc = torch.empty((t, p), dtype=f32, device=dev)
    blnd = torch.empty((t, p), dtype=f32, device=dev)
    alive = torch.empty((t, k), dtype=i8, device=dev)
    kproc = torch.empty((t,), dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.blend_tiles_fused_launch(
        pix.data_ptr(), feat.data_ptr(), colors.data_ptr(), valid.data_ptr(),
        allow.data_ptr(), kblock_bound.data_ptr(), t0.data_ptr(),
        acc0.data_ptr(), p0.data_ptr(), b0.data_ptr(), rgb.data_ptr(),
        trans.data_ptr(), proc.data_ptr(), blnd.data_ptr(),
        alive.data_ptr(), kproc.data_ptr(), t, k, ALPHA_MIN, ALPHA_MAX,
        T_EPS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_tiles_fused launch failed: cudaError "
                           f"{err}")
    global launches
    launches += 1
    return FusedBlendOut(rgb=rgb, trans=trans, processed=proc, blended=blnd,
                         entry_alive=alive != 0, kblocks_processed=kproc,
                         kblocks_total=-(-k // K_BLK))


def blend_tiles_plain(pix, feat, colors, valid, allow):
    """Plain PyTorch version of the full-sweep kernel: every entry of every
    tile folded front to back in `core.raster.blend_pass`'s operation order,
    without termination. Returns (rgb (T, P, 3), trans (T, P))."""
    t, p, _ = pix.shape
    mt_idx = pixel_minitile_index(p, allow.shape[2], pix.device)
    trans = torch.ones((t, p), dtype=torch.float32, device=pix.device)
    rgb = torch.zeros((t, p, 3), dtype=torch.float32, device=pix.device)
    valid_b = valid != 0
    for kk in range(feat.shape[1]):
        lane = valid_b[:, kk, None] & (allow[:, kk][:, mt_idx] != 0)
        a = entry_alpha(pix, feat[:, kk, 0:2], feat[:, kk, 2:5],
                        feat[:, kk, 5], lane)
        rgb = rgb + (trans * a)[..., None] * colors[:, kk, None, :]
        trans = trans * (1.0 - a)
    return rgb, trans


def blend_tiles(pix: torch.Tensor, feat: torch.Tensor, colors: torch.Tensor,
                valid: torch.Tensor, allow: torch.Tensor):
    """Full-sweep blend of every list slot of every tile.

    Operands as for `blend_tiles_fused` (module docstring). Returns (rgb
    (T, P, 3), trans (T, P)). CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream.
    """
    t, p, _ = pix.shape
    k = feat.shape[1]
    dev = pix.device
    if dev.type == "cpu":
        return blend_tiles_plain(pix, feat, colors, valid, allow)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f32, i8 = torch.float32, torch.int8
    check("pix", pix, f32, (t, PIXELS, 2), dev)
    check("feat", feat, f32, (t, k, 8), dev)
    check("colors", colors, f32, (t, k, 3), dev)
    check("valid", valid, i8, (t, k), dev)
    check("allow", allow, i8, (t, k, MINITILES), dev)
    rgb = torch.empty((t, p, 3), dtype=f32, device=dev)
    trans = torch.empty((t, p), dtype=f32, device=dev)
    lib = _full_lib()
    err = lib.blend_tiles_launch(
        pix.data_ptr(), feat.data_ptr(), colors.data_ptr(), valid.data_ptr(),
        allow.data_ptr(), rgb.data_ptr(), trans.data_ptr(), t, k, ALPHA_MIN,
        ALPHA_MAX, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend_tiles launch failed: cudaError {err}")
    global full_launches
    full_launches += 1
    return rgb, trans


def _full_lib() -> ctypes.CDLL:
    lib = build.load("blend_full")
    fn = lib.blend_tiles_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 7 + [ci, ci, cf, cf, vp]
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = build.load("blend_fused")
    fn = lib.blend_tiles_fused_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 16 + [ci, ci, cf, cf, cf, vp]
        fn.restype = ctypes.c_int
    return lib
