"""The comparison that decides `correct`: served frames against the
reference's.

Two numbers, each with its limit from the configuration file's "limits"
(set from measured readings, `PERF.md` gives them):

  max_abs   the widest gap of any colour channel of any pixel, over the
            compared frames
  rms       the worst compared frame's root-mean-square gap

A number that is not finite fails.
"""
from __future__ import annotations

import math

import torch


def frame_gaps(image: torch.Tensor, ref: torch.Tensor) -> dict:
    """The gaps of one frame, (H, W, 3) each, as Python floats."""
    d = (image.float() - ref.float()).abs()
    return dict(max_abs=float(d.max()),
                rms=float(torch.sqrt(torch.mean(d.double() ** 2))))


def combine(gaps: list[dict]) -> dict:
    """The numbers over all compared frames: the worst of each."""
    return {k: max(g[k] for g in gaps) for k in ("max_abs", "rms")}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks = {k: dict(value=numbers[k], limit=float(limits[k]))
              for k in ("max_abs", "rms")}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
