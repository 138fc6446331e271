"""Precision emulation for the mixed-precision CTU study (paper §IV-C).

The schemes differ in WHERE quantization hits:

  FULL_FP16 — coordinates, Δ, products, sums all fp16.
  FULL_FP8  — coordinates (p, μ′) quantized to fp8 BEFORE the subtract.
  MIXED     — the paper's CTU: Δ = p − μ′ computed in FP16, THEN converted
              to FP8 for the quadratic unit; accumulation in FP16.

Quantization is a round trip through the narrow type and back to float32,
one rounding per step. fp8 is e4m3fn with the overflow rule of a
non-saturating conversion: |x| > 464 (the midpoint past the largest finite
value 448) and ±inf become NaN, and a NaN weight never passes a CAT
comparison. torch's own `.to(torch.float8_e4m3fn)` saturates to ±448
instead, so `_quant` restores NaN explicitly.
"""
from __future__ import annotations

import dataclasses

import torch

FP8 = torch.float8_e4m3fn
FP8_OVERFLOW = 464.0   # |x| above this rounds past e4m3fn's 448 -> NaN


@dataclasses.dataclass(frozen=True)
class PrecisionScheme:
    coord: str = "fp32"   # p, μ′, conic entries entering the unit
    delta: str = "fp32"   # Δ after the subtract (input to the quad unit)
    mul: str = "fp32"     # multiplier outputs (lines 2-5)
    acc: str = "fp32"     # adder outputs (lines 6-7)
    # The CTU tests lhs > E·(1-slack), so the bounded quantization error of
    # the quad unit can only produce false positives, never false negatives.
    slack: float = 0.0

    def q_coord(self, x):
        return _quant(x, self.coord)

    def q_delta(self, x):
        return _quant(x, self.delta)

    def q_mul(self, x):
        return _quant(x, self.mul)

    def q_acc(self, x):
        return _quant(x, self.acc)


FULL_FP32 = PrecisionScheme()
FULL_FP16 = PrecisionScheme("fp16", "fp16", "fp16", "fp16")
FULL_FP8 = PrecisionScheme("fp8", "fp8", "fp16", "fp16", slack=0.15)
MIXED = PrecisionScheme("fp16", "fp8", "fp16", "fp16", slack=0.15)


def _quant(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fp32":
        return x
    if kind == "fp16":
        return x.to(torch.float16).to(torch.float32)
    if kind == "fp8":
        q = x.to(FP8).to(torch.float32)
        return torch.where(x.abs() > FP8_OVERFLOW,
                           torch.full_like(q, float("nan")), q)
    raise ValueError(kind)
