"""Train any assigned LM architecture (reduced config) through the PyTorch
port's production code path: the training driver's step, AdamW,
checkpointing, int8 gradient compression with error feedback, straggler
monitoring.

    PYTHONPATH=src python examples/torch_train_lm.py \\
        --arch deepseek-v2-lite-16b [--device cpu]

Calls `repro_torch.launch.train.main` on `--device` (default cuda; with
cuda and no CUDA device it exits 2 without running). Checkpoints go to
`--ckpt-dir` (default: repro_torch_<arch>_ckpt under the temporary
directory); a run finding a checkpoint there resumes from it.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir",
                    help="checkpoint directory (default: "
                         "repro_torch_<arch>_ckpt under the temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), f"repro_torch_{args.arch}_ckpt")
    return train_main(["--arch", args.arch, "--reduced",
                       "--steps", str(args.steps), "--batch", "4",
                       "--seq", "64", "--compress", "int8",
                       "--ckpt-dir", ckpt_dir, "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
