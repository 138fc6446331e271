"""The PRTU kernels: the Mini-Tile CAT (Alg. 1, paper §IV-C) on Hopper.

`prtu_entry_cat_mask` (K1, the survivor-stream CTU) tests every compacted
per-tile list entry against the Mt mini-tiles of its own tile and returns
the (T, K, Mt) int8 mask the blend consumes (`csrc/prtu_entry.cu`).
`prtu_cat_mask` (K4, the dense-mask oracle's CTU) tests every (mini-tile,
Gaussian) pair of the frame and returns an (M, N) int8 mask
(`csrc/prtu_dense.cu`). Both kernels share Alg. 1's per-pair body
(`csrc/alg1.cuh`). On CUDA tensors each wrapper launches its kernel; on
CPU tensors it runs its plain PyTorch version (`core.cat`'s Alg. 1).

`alg1_quant` is a test hook into `csrc/alg1.cuh`: the kernels' one-value
and two-value rounding steps applied to a float buffer, against the plain
quantizer of `core.precision`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.cat import SamplingMode, pr_gaussian_weight, \
    select_mode
from repro_torch.core.precision import PrecisionScheme, _quant
from repro_torch.kernels import build
from repro_torch.kernels.build import check_aligned
from repro_torch.kernels.build import check_operand as check

MODE_CODES = {"uniform_dense": 0, "uniform_sparse": 1, "smooth_focused": 2,
              "spiky_focused": 3}
PREC_CODES = {"fp32": 0, "fp16": 1, "fp8": 2}
MINITILES = 16          # the kernel's mini-tiles per tile (4x4 of 4x4 px)
DENSE_SIDE = 8          # region side (mini-tiles) of a csrc/prtu_dense.cu block
DENSE_COLS = 512        # Gaussian columns of a csrc/prtu_dense.cu block

launches = 0            # K1 launches since the last reset to 0
dense_launches = 0      # K4 launches since the last reset to 0


def prtu_entry_cat_mask_plain(p_top_local, p_bot_local, tile_origins, mu,
                              conic, lhs, spiky, *, mode, coord_prec,
                              delta_prec, mul_prec, acc_prec, slack):
    """Plain PyTorch version of the kernel (same operands, same result)."""
    prec = PrecisionScheme(coord_prec, delta_prec, mul_prec, acc_prec,
                           slack=slack)
    orig = tile_origins[:, None, :]
    E = pr_gaussian_weight(mu[:, :, None, :], conic[:, :, None, :],
                           (orig + p_top_local)[:, None],
                           (orig + p_bot_local)[:, None], prec)
    ok = lhs[:, :, None, None] > E * (1.0 - slack)            # (T, K, Mt, 4)
    hit = select_mode(ok, (spiky != 0)[:, :, None], SamplingMode(mode))
    return hit.to(torch.int8)


def check_entry_index(t: int, k: int) -> None:
    """The entry kernel indexes entries, their conic rows (3·e + 2) and
    their mask bytes in int32: raise unless T·K·Mt < 2**31. A batch folded
    into the tile axis (B·T rows) is held to the same bound."""
    if t * k * MINITILES >= 2 ** 31:
        raise ValueError(f"{t}x{k} entries x {MINITILES} mini-tiles exceed "
                         "the entry kernel's int32 index")


def prtu_entry_cat_mask(p_top_local: torch.Tensor, p_bot_local: torch.Tensor,
                        tile_origins: torch.Tensor, mu: torch.Tensor,
                        conic: torch.Tensor, lhs: torch.Tensor,
                        spiky: torch.Tensor, *, mode: str = "smooth_focused",
                        coord_prec: str = "fp16", delta_prec: str = "fp8",
                        mul_prec: str = "fp8", acc_prec: str = "fp16",
                        slack: float = 0.0) -> torch.Tensor:
    """(T, K, Mt) int8 CAT mask over compacted list entries.

    p_top_local/p_bot_local: (Mt, 2) float32 tile-local leader coords;
    tile_origins: (T, 2) float32; mu (T, K, 2), conic (T, K, 3), lhs (T, K)
    float32 with lhs = -inf on invalid entries (they never pass); spiky
    (T, K) int8. CPU tensors take the plain version; CUDA tensors launch
    the kernel (Mt must be 16) on the current stream.
    """
    kw = dict(mode=mode, coord_prec=coord_prec, delta_prec=delta_prec,
              mul_prec=mul_prec, acc_prec=acc_prec, slack=slack)
    if mu.device.type == "cpu":
        return prtu_entry_cat_mask_plain(p_top_local, p_bot_local,
                                         tile_origins, mu, conic, lhs, spiky,
                                         **kw)
    if mu.device.type != "cuda":
        raise ValueError(f"unsupported device {mu.device}")
    t, k = lhs.shape
    dev = mu.device
    f32 = torch.float32
    check("p_top_local", p_top_local, f32, (MINITILES, 2), dev)
    check("p_bot_local", p_bot_local, f32, (MINITILES, 2), dev)
    check("tile_origins", tile_origins, f32, (t, 2), dev)
    check("mu", mu, f32, (t, k, 2), dev)
    check("conic", conic, f32, (t, k, 3), dev)
    check("lhs", lhs, f32, (t, k), dev)
    check("spiky", spiky, torch.int8, (t, k), dev)
    check_aligned("mu", mu, 8)                     # read as float2
    check_entry_index(t, k)
    codes = _codes(mode, coord_prec, delta_prec, mul_prec, acc_prec)
    out = torch.empty((t, k, MINITILES), dtype=torch.int8, device=dev)
    lib = _lib()
    err = lib.prtu_entry_cat_mask_launch(
        p_top_local.data_ptr(), p_bot_local.data_ptr(),
        tile_origins.data_ptr(), mu.data_ptr(), conic.data_ptr(),
        lhs.data_ptr(), spiky.data_ptr(), out.data_ptr(), t * k, k, *codes,
        1.0 - slack, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prtu_entry_cat_mask launch failed: cudaError "
                           f"{err}")
    global launches
    launches += 1
    return out


def prtu_cat_mask_plain(p_top, p_bot, mu, conic, lhs, spiky, *,
                        mode: str = "smooth_focused", coord_prec: str = "fp16",
                        delta_prec: str = "fp8", mul_prec: str = "fp8",
                        acc_prec: str = "fp16", slack: float = 0.0):
    """Plain PyTorch version of the dense kernel (same operands, same
    result, same defaults); also the kernel's oracle,
    `ref.prtu_cat_mask_ref`."""
    prec = PrecisionScheme(coord_prec, delta_prec, mul_prec, acc_prec,
                           slack=slack)
    E = pr_gaussian_weight(mu[None, :, :], conic[None, :, :],
                           p_top[:, None, :], p_bot[:, None, :], prec)
    ok = lhs[None, :, None] > E * (1.0 - slack)               # (M, N, 4)
    hit = select_mode(ok, (spiky != 0)[None, :], SamplingMode(mode))
    return hit.to(torch.int8)


def prtu_cat_mask(p_top: torch.Tensor, p_bot: torch.Tensor, mu: torch.Tensor,
                  conic: torch.Tensor, lhs: torch.Tensor, spiky: torch.Tensor,
                  *, mode: str = "smooth_focused", coord_prec: str = "fp16",
                  delta_prec: str = "fp8", mul_prec: str = "fp8",
                  acc_prec: str = "fp16", slack: float = 0.0,
                  width: Optional[int] = None) -> torch.Tensor:
    """(M, N) int8 CAT mask over every (mini-tile, Gaussian) pair.

    p_top/p_bot: (M, 2) float32 image-space leader coords of each
    mini-tile's pixel rectangle; mu (N, 2), conic (N, 3), lhs (N,) float32
    with lhs = -inf on culled Gaussians (they never pass); spiky (N,) int8.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream. The mask holds only 0 and 1.

    width: mini-tiles per image row when the rows are an image's mini-tiles
    in row-major order (`TileGrid.minitile_origins`); None reads the rows
    as one band. The kernel checks the leaders against the layout and
    takes its exact per-pair path where they do not fit it, so `width`
    only decides the speed: the result is the same.
    """
    kw = dict(mode=mode, coord_prec=coord_prec, delta_prec=delta_prec,
              mul_prec=mul_prec, acc_prec=acc_prec, slack=slack)
    if mu.device.type == "cpu":
        return prtu_cat_mask_plain(p_top, p_bot, mu, conic, lhs, spiky, **kw)
    if mu.device.type != "cuda":
        raise ValueError(f"unsupported device {mu.device}")
    m, n = p_top.shape[0], mu.shape[0]
    dev = mu.device
    f32 = torch.float32
    check("p_top", p_top, f32, (m, 2), dev)
    check("p_bot", p_bot, f32, (m, 2), dev)
    check("mu", mu, f32, (n, 2), dev)
    check("conic", conic, f32, (n, 3), dev)
    check("lhs", lhs, f32, (n,), dev)
    check("spiky", spiky, torch.int8, (n,), dev)
    for name, x in (("p_top", p_top), ("p_bot", p_bot), ("mu", mu)):
        check_aligned(name, x, 8)                  # read as float2
    width = max(m, 1) if width is None else int(width)
    if width < 1:
        raise ValueError(f"width must be positive, got {width}")
    # Rows and columns index in int32, and so do the grid's regions of
    # DENSE_SIDE x DENSE_SIDE rows; its column blocks of DENSE_COLS are at
    # most 65535. Output offsets are 64-bit in the kernel.
    height = -(-m // width)
    regions = -(-width // DENSE_SIDE) * -(-height // DENSE_SIDE)
    if (m >= 2 ** 31 or n >= 2 ** 31 or regions >= 2 ** 31
            or -(-n // DENSE_COLS) > 65535):
        raise ValueError(f"a {m}x{n} mask exceeds the kernel's grid")
    codes = _codes(mode, coord_prec, delta_prec, mul_prec, acc_prec)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    lib = _dense_lib()
    err = lib.prtu_cat_mask_launch(
        p_top.data_ptr(), p_bot.data_ptr(), mu.data_ptr(), conic.data_ptr(),
        lhs.data_ptr(), spiky.data_ptr(), out.data_ptr(), m, n, width,
        *codes, 1.0 - slack, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prtu_cat_mask launch failed: cudaError {err}")
    global dense_launches
    dense_launches += 1
    return out


def alg1_quant(x: torch.Tensor, kind: str, paired: bool = False):
    """`x` (float32, 1-D) rounded to precision `kind` ("fp32", "fp16",
    "fp8") and back, as the PRTU kernels round each step of Alg. 1.

    CPU tensors take the plain quantizer (`core.precision._quant`); CUDA
    tensors launch `alg1::quant` of `csrc/alg1.cuh` elementwise, or its
    two-value form `alg1::quant2` over consecutive pairs when `paired`
    (then len(x) must be even). A test hook: no path of the renderer calls
    it, and it counts no launches."""
    if x.device.type == "cpu":
        return _quant(x, kind)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.numel()
    check("x", x, torch.float32, (n,), x.device)
    if kind not in PREC_CODES:
        raise ValueError(f"unknown precision {kind!r}")
    if paired and n % 2:
        raise ValueError("paired rounding needs an even length")
    out = torch.empty_like(x)
    hook = _lib().alg1_quant_launch
    if hook.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        hook.argtypes = [vp, vp, ctypes.c_longlong, ci, ci, vp]
        hook.restype = ctypes.c_int
    err = hook(
        x.data_ptr(), out.data_ptr(), n, PREC_CODES[kind], int(paired),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alg1_quant launch failed: cudaError {err}")
    return out


def _codes(mode, coord_prec, delta_prec, mul_prec, acc_prec) -> tuple:
    """The kernels' integer codes of a sampling mode and four precisions."""
    if mode not in MODE_CODES:
        raise ValueError(f"unknown mode {mode!r}")
    precs = (coord_prec, delta_prec, mul_prec, acc_prec)
    for p in precs:
        if p not in PREC_CODES:
            raise ValueError(f"unknown precision {p!r}")
    return (MODE_CODES[mode],) + tuple(PREC_CODES[p] for p in precs)


def _dense_lib() -> ctypes.CDLL:
    lib = build.load("prtu_dense")
    fn = lib.prtu_cat_mask_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 8 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = build.load("prtu_entry")
    fn = lib.prtu_entry_cat_mask_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [ci] * 7 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib
