"""Float32 spreads of the port's LM on a card, the numbers behind the
gates of `models.parity` and `chip_smoke.py` phases 13 and 14.

    python tools/torch_lm_spreads.py [--seeds 20 10 0 1 2 3] [--depths 1 2 4 8 24]
    python tools/torch_lm_spreads.py --families [--device cpu]

1. Card against CPU (reduced qwen1.5-0.5b, float32 compute, the weights
   drawn on the CPU and copied): `models.parity.lm_parity` on a (2, 20)
   prompt and 8 teacher-forced tokens drawn from each seed; prints every
   logit error and the bf16 caches' rounding steps.
2. Depth sweep at full width (qwen1.5-0.5b, float32, batch 4 x 256): the
   forward's logits over (data=2, model=2) virtual shards of the card
   against one device, and one device against itself with the batch in
   two halves, on seed-0 weights and with the attention projections at
   their fan-in (`chip_smoke.fan_in_attention`), each over max|logit|.

3. `--families` (instead of 1 and 2): for deepseek-v2-lite-16b,
   mamba2-780m, zamba2-1.2b and seamless-m4t-large-v2 by depth, float32
   weights and compute, batch 4 x 256 (the enc-dec with 256 encoder
   frames of N(0, 1)), the attention projections at their fan-in: the
   forward's logits over (data=2, model=2) against one device, and one
   device against itself with the batch in two halves, each over
   max|logit|. At full width on the card (deepseek to 8 layers: two
   float32 copies of its 27 do not fit); `--device cpu` runs the
   `reduced` configs at the depths `FAMILY_DEPTHS_CPU` lists.

Prints the card's name and power limit first. Needs a CUDA device, but
for `--families --device cpu`.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import torch  # noqa: E402

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.distributed.sharding import Mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.parity import lm_parity  # noqa: E402


def card_vs_cpu(seed: int, dev) -> dict:
    cfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")),
                              dtype="float32", attn_chunk=8)
    cpu = Model(cfg, device="cpu", seed=0)
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(dev) for k, v in cpu.state_dict().items()},
                         assign=True)
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (2, 20), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    return lm_parity(card, cpu, prompt, toks, dev, "cpu")


def depth_row(depth: int, fan_in: bool, dev) -> tuple:
    from chip_smoke import fan_in_attention
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b"), dtype="float32",
                              num_layers=depth)
    one = Model(cfg, device=dev, seed=0)
    if fan_in:
        fan_in_attention(one)
    mesh = Model(cfg, device=dev, seed=0, mesh=Mesh([[dev, dev], [dev, dev]]))
    mesh.load_state_dict(one.state_dict())
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen).to(dev)
    batch = dict(tokens=toks)
    with torch.no_grad():
        want = one.forward(batch)[0]
        scale = float(want.abs().max())
        split = torch.cat([one.forward(dict(tokens=toks[:2]))[0],
                           one.forward(dict(tokens=toks[2:]))[0]])
        got = mesh.forward(batch)[0]
    return (float((got - want).abs().max()) / scale,
            float((split - want).abs().max()) / scale)


FAMILY_DEPTHS = {"deepseek-v2-lite-16b": (2, 4, 8),
                 "mamba2-780m": (2, 8, 24, 48),
                 "zamba2-1.2b": (2, 6, 12, 38),
                 "seamless-m4t-large-v2": (2, 8, 24)}
FAMILY_DEPTHS_CPU = {"deepseek-v2-lite-16b": (2, 4),
                     "mamba2-780m": (2, 4),
                     "zamba2-1.2b": (2, 4),
                     "seamless-m4t-large-v2": (2, 4)}


def family_row(name: str, depth: int, dev, small: bool) -> tuple:
    """(mesh vs one device, one device vs itself with the batch in two
    halves), the float32 forward's logits over max|logit|, for `name` cut
    to `depth` layers (the enc-dec's encoder too), weights at fan-in."""
    from chip_smoke import fan_in_attention
    cfg = get_arch(name)
    if small:
        cfg = reduced(cfg)
    extra = dict(encoder_layers=depth) if cfg.family == "encdec" else {}
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                              num_layers=depth, **extra)
    one = Model(cfg, device=dev, seed=0)
    fan_in_attention(one)
    mesh = Model(cfg, device=dev, seed=0, mesh=Mesh([[dev, dev],
                                                     [dev, dev]]))
    mesh.load_state_dict(one.state_dict())
    gen = torch.Generator().manual_seed(5)
    s = 64 if small else 256
    batch = dict(tokens=torch.randint(0, cfg.vocab_size, (4, s),
                                      generator=gen).to(dev))
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((4, s, cfg.d_model),
                                          generator=gen).to(dev)
    with torch.no_grad():
        want = one.forward(batch)[0]
        scale = float(want.abs().max())
        got = mesh.forward(batch)[0]
        m = float((got - want).abs().max()) / scale
        del got
        split = torch.cat([one.forward({k: v[:2] for k, v in
                                        batch.items()})[0],
                           one.forward({k: v[2:] for k, v in
                                        batch.items()})[0]])
    return m, float((split - want).abs().max()) / scale


def families(dev) -> None:
    small = dev.type == "cpu"
    for name, depths in (FAMILY_DEPTHS_CPU if small
                         else FAMILY_DEPTHS).items():
        for depth in depths:
            m, s = family_row(name, depth, dev, small)
            print(f"{name}{' reduced' if small else ''} depth {depth:2d}: "
                  f"mesh vs one device {m:.3e}, one device vs itself "
                  f"(batch in halves) {s:.3e} x max|logit|", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[20, 10, 0, 1, 2,
                                                             3])
    ap.add_argument("--depths", type=int, nargs="*", default=[1, 2, 4, 8, 24])
    ap.add_argument("--families", action="store_true",
                    help="the MoE/MLA, SSM, hybrid and enc-dec depth sweep "
                    "(3) instead of 1 and 2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.families and args.device == "cpu":
        families(torch.device("cpu"))
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    if args.families:
        families(dev)
        return 0
    for seed in args.seeds:
        r = card_vs_cpu(seed, dev)
        print(f"card vs CPU, seed {seed}: " + ", ".join(
            f"{k} {e:.3e}"
            + ("" if ok is None else f" ({'ok' if ok else 'FAIL'})")
            for k, (e, ok) in r.items()), flush=True)
    for depth in args.depths:
        for fan_in in (False, True):
            m, s = depth_row(depth, fan_in, dev)
            print(f"depth {depth:2d}, fan_in {fan_in}: mesh vs one device "
                  f"{m:.3e}, one device vs itself (batch in halves) {s:.3e} "
                  "x max|logit|", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
