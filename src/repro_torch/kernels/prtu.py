"""The PRTU kernels: the Mini-Tile CAT (Alg. 1, paper §IV-C) on Hopper.

`prtu_entry_cat_mask` (K1, the survivor-stream CTU) tests every compacted
per-tile list entry against the Mt mini-tiles of its own tile and returns
the (T, K, Mt) int8 mask the blend consumes (`csrc/prtu_entry.cu`).
`prtu_cat_mask` (K4, the dense-mask oracle's CTU) tests every (mini-tile,
Gaussian) pair of the frame and returns an (M, N) int8 mask
(`csrc/prtu_dense.cu`). Both kernels share Alg. 1's per-pair body
(`csrc/alg1.cuh`). On CUDA tensors each wrapper launches its kernel; on
CPU tensors it runs its plain PyTorch version (`core.cat`'s Alg. 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.cat import SamplingMode, pr_gaussian_weight, \
    select_mode
from repro_torch.core.precision import PrecisionScheme
from repro_torch.kernels import build
from repro_torch.kernels.build import check_operand as check

MODE_CODES = {"uniform_dense": 0, "uniform_sparse": 1, "smooth_focused": 2,
              "spiky_focused": 3}
PREC_CODES = {"fp32": 0, "fp16": 1, "fp8": 2}
MINITILES = 16          # the kernel's mini-tiles per tile (4x4 of 4x4 px)
DENSE_ROWS = 128        # mini-tile rows per block of csrc/prtu_dense.cu

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
    if t * k >= 2 ** 31:
        raise ValueError(f"{t}x{k} entries exceed the kernel's int32 index")
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
                  acc_prec: str = "fp16", slack: float = 0.0) -> torch.Tensor:
    """(M, N) int8 CAT mask over every (mini-tile, Gaussian) pair.

    p_top/p_bot: (M, 2) float32 image-space leader coords of each
    mini-tile's pixel rectangle; mu (N, 2), conic (N, 3), lhs (N,) float32
    with lhs = -inf on culled Gaussians (they never pass); spiky (N,) int8.
    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream. The mask holds only 0 and 1.
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
    # Rows and columns index in int32 (the row grid in at most 65535
    # blocks of DENSE_ROWS); output offsets are 64-bit in the kernel.
    if m >= 2 ** 31 or n >= 2 ** 31 or -(-m // DENSE_ROWS) > 65535:
        raise ValueError(f"a {m}x{n} mask exceeds the kernel's grid")
    codes = _codes(mode, coord_prec, delta_prec, mul_prec, acc_prec)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    lib = _dense_lib()
    err = lib.prtu_cat_mask_launch(
        p_top.data_ptr(), p_bot.data_ptr(), mu.data_ptr(), conic.data_ptr(),
        lhs.data_ptr(), spiky.data_ptr(), out.data_ptr(), m, n, *codes,
        1.0 - slack, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prtu_cat_mask launch failed: cudaError {err}")
    global dense_launches
    dense_launches += 1
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
        fn.argtypes = [vp] * 7 + [ci] * 7 + [ctypes.c_float, vp]
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
