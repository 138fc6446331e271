"""Synthetic token pipeline: deterministic, shardable, restart-exact, as
the reference's `repro/data/tokens.py`.

A real deployment swaps `synthetic_batch` for a tokenized corpus reader;
the contract that matters for the framework is kept here:

  - deterministic as a function of (seed, step), and different from step
    to step -> a restart neither replays nor skips data (a checkpoint
    stores only the step);
  - per-host sharding: each data-parallel rank takes only its slice
    (`host_slice`);
  - next-token labels precomputed (-1 padding masked out of the loss).

The reference draws from the jax PRNG; the port keeps its contract, not
its stream. Each batch is drawn on the CPU from a `torch.Generator`
seeded from (seed, step), then moved to `device`, so the card and the
CPU see the same batch. Tokens and labels are int64 (torch's index
type), embeddings bf16 as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose seed mixes (seed, step)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator().manual_seed((int(hi) << 31) ^ int(lo))


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    seed: int = 0, device="cpu") -> dict:
    """The full global batch of `step` (single-process runs and tests).

    dense: "tokens" and "labels" from one (B, S + 1) draw, the labels the
    tokens shifted by one; `cfg.embeds_input`: bf16 "embeds" (B, S, D)
    and independent "labels"; enc-dec: bf16 "enc_embeds" of S/2 frames,
    decoder "tokens" (B, S/2) and "labels" = the tokens shifted, -1 last.
    """
    gen = _generator(seed, step)
    b, s = shape.global_batch, shape.seq_len

    def randint(shape_):
        return torch.randint(0, cfg.vocab_size, shape_, generator=gen)

    def normal(shape_):
        return torch.randn(shape_, generator=gen).to(torch.bfloat16)

    if cfg.family == "encdec":
        half = s // 2
        enc = normal((b, half, cfg.d_model))
        toks = randint((b, half))
        out = dict(enc_embeds=enc, tokens=toks, labels=_shift(toks))
    elif cfg.embeds_input:
        emb = normal((b, s, cfg.d_model))
        out = dict(embeds=emb, labels=randint((b, s)))
    else:
        toks = randint((b, s + 1))
        out = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    return {k: v.contiguous().to(device) for k, v in out.items()}


def _shift(tokens):
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                     dim=1)


def host_slice(batch: dict, rank: int, world: int) -> dict:
    """Slice a global batch for one data-parallel host."""
    def sl(x):
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]
    return {k: sl(v) for k, v in batch.items()}
