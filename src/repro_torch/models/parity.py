"""Logit parity of two runs of one LM: two devices (the card against the
CPU), or a mesh against one device, from the same weights and tokens.

Forward and prefill logits are held at rtol 1e-4 and atol 1e-4 x
max|logit|. Decode is teacher-forced twice. Under float32 caches
(`float32_caches`) every step is float32 arithmetic, held at the same
tolerance. Under the model's own caches (bf16, or int8 with `kv_quant`)
the two runs' float32 K/V, which differ in the last places, are rounded
to the cache: now and then a value lies so near a rounding boundary that
the two round it apart, and that one step moves the later logits by more
than float32 noise (up to 1.80e-4 of max|logit| on an H100 against the
CPU, reduced qwen1.5-0.5b over six seeds: `tools/torch_lm_spreads.py`;
float32 caches 0.9-1.6e-6). So the model's caches are
held element by element instead: within one rounding step (`cache_steps`)
past float32 noise, and their logits are reported, not gated.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import flatten
from repro_torch.distributed.sharding import Sharded, map_with

RTOL = 1e-4


def _whole(x):
    return x.gather() if isinstance(x, Sharded) else x


def float32_caches(caches):
    """`caches` with every bf16 tensor (or `Sharded` piece) as float32; the
    decode writes and reads its caches in their own dtype."""
    def conv(x):
        if isinstance(x, Sharded):
            return x.map(conv)
        if torch.is_tensor(x) and x.dtype == torch.bfloat16:
            return x.float()
        return x
    return map_with(lambda x, _: conv(x), caches, caches)


def decode_tokens(model, tokens, caches) -> tuple:
    """Teacher-forced decode of `tokens` (B, S) from `caches`: (logits
    (B, S, V), caches)."""
    outs = []
    for i in range(tokens.shape[1]):
        lg, caches = model.decode_step(caches, tokens[:, i:i + 1])
        outs.append(lg)
    return torch.stack(outs, 1), caches


def logit_error(got, want) -> tuple:
    """(max |Δ| / max|logit|, whether every element is within rtol 1e-4
    and atol 1e-4 x max|logit|), on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max())
    err = (got - want).abs()
    ok = bool((err <= RTOL * scale + RTOL * want.abs()).all())
    return float(err.max()) / scale, ok


def cache_steps(got, want) -> float:
    """The largest difference of two cache tensors in rounding steps of
    their dtype: int8 in steps; bf16 in ulps of the larger of each pair,
    past float32 noise of 1e-5 of `want`'s largest magnitude (a value that
    cancels to near zero carries its terms' rounding); float32 (scales)
    relative to `want`'s largest magnitude, in units of 1e-5."""
    got, want = _whole(got).detach().cpu(), _whole(want).detach().cpu()
    if want.dtype == torch.int8:
        return float((got.int() - want.int()).abs().max())
    a, b = got.float(), want.float()
    noise = 1e-5 * float(b.abs().max())
    if want.dtype == torch.float32:
        return float((a - b).abs().max()) / max(noise, 1e-30)
    big = torch.maximum(a.abs(), b.abs()).numpy()
    ulp = torch.from_numpy(np.spacing(big.astype(np.float32))) * 2 ** 16
    return float((((a - b).abs() - noise).clamp(min=0) / ulp).max())


def lm_parity(got_model, want_model, prompt, tokens, got_dev, want_dev,
              cache_len=None) -> dict:
    """Both models' forward and prefill logits on `prompt`, and their
    teacher-forced decode of `tokens` from fresh caches of `cache_len`
    (default the tokens' length) under float32 caches and under the
    model's own. Returns {label: (error, ok)}: the logit errors with
    `logit_error`'s gate (model-cache logits with ok None: reported
    only) and "caches": (the largest `cache_steps`, <= 1)."""
    b, s = tokens.shape
    n = cache_len or s
    out = {}

    def both(fn):
        return (fn(got_model, got_dev), fn(want_model, want_dev))
    out["forward"] = logit_error(*both(
        lambda m, d: m.forward(dict(tokens=prompt.to(d)))[0]))
    out["prefill"] = logit_error(*both(
        lambda m, d: m.prefill(dict(tokens=prompt.to(d)))[0]))
    out["decode_f32_cache"] = logit_error(*both(
        lambda m, d: decode_tokens(m, tokens.to(d),
                                   float32_caches(m.init_caches(b, n)))[0]))
    (g, gc), (w, wc) = both(
        lambda m, d: decode_tokens(m, tokens.to(d), m.init_caches(b, n)))
    out["decode_model_cache"] = (logit_error(g, w)[0], None)
    steps = max(cache_steps(x, y) for x, y in zip(flatten(gc), flatten(wc))
                if not isinstance(y, int))
    out["caches"] = (steps, steps <= 1)
    return out


def failures(result: dict) -> list:
    """The labels of `lm_parity`'s result whose gate failed."""
    return [k for k, (_, ok) in result.items() if ok is False]
