"""The least time the H100 could take for the work a frame needs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM. A bound is the
larger of the operations at the one and the bytes at the other.

The counts are the reference's (`reference.render.Counts`): work the
inputs need, whatever implements it, so no change of passes, k_max,
K-blocks or layouts can push a share past 100%. The arithmetic per unit is
that of the port's kernels (`chip_smoke.py`'s K1 and K2 bounds), counted
only where the inputs need it:

  K1 (the CTU's mini-tile test) per needed (Gaussian, tile) pair: 16
     mini-tiles, each with the corners the sampling mode tests (4 for a
     smooth Gaussian, 2 for a spiky one under SMOOTH_FOCUSED) at 11 fp32
     operations a corner (44 for the kernel's four); it reads the pair's
     mean, conic, opacity term and spiky flag (25 bytes) and writes its 16
     mini-tile bits (2 bytes).
  K2 (the blend) per blended lane: 26 fp32 operations (exponent 11, its
     negation, exp, opacity product, clamp, threshold compare and select,
     T*a, 3 colour products and 3 adds, 1 - a, T*(1 - a)); it reads the
     features and colour of each entry with a blended lane (36 bytes) and
     writes the image once (12 bytes a pixel).
  The frame: every Gaussian projected (150 fp32 operations, a lower count
     of the EWA arithmetic), K1's and K2's operations; it reads the scene
     once (56 bytes a Gaussian) and writes the image once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

OPS_PER_CORNER = 11
CORNERS_SMOOTH, CORNERS_SPIKY = 4, 2
MINITILES = 16
K1_PAIR_BYTES = 25 + 2
K2_OPS_PER_LANE = 26
K2_ENTRY_BYTES = 36
IMAGE_BYTES_PER_PIXEL = 12
PROJECT_OPS = 150
SCENE_BYTES_PER_GAUSSIAN = 56


def bound_s(n_ops: float, n_bytes: float) -> float:
    """Seconds the card needs at least: the slower of the two peaks."""
    return max(n_ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S)


def k1_ops(c) -> float:
    return MINITILES * OPS_PER_CORNER * (CORNERS_SMOOTH * c.pairs_smooth
                                         + CORNERS_SPIKY * c.pairs_spiky)


def k1_bound_s(c) -> float:
    return bound_s(k1_ops(c), K1_PAIR_BYTES * c.pairs)


def k2_ops(c) -> float:
    return K2_OPS_PER_LANE * c.lanes


def k2_bound_s(c) -> float:
    return bound_s(k2_ops(c), K2_ENTRY_BYTES * c.entries_blended
                   + IMAGE_BYTES_PER_PIXEL * c.pixels)


def frame_bound_s(c) -> float:
    return bound_s(PROJECT_OPS * c.gaussians + k1_ops(c) + k2_ops(c),
                   SCENE_BYTES_PER_GAUSSIAN * c.gaussians
                   + IMAGE_BYTES_PER_PIXEL * c.pixels)
