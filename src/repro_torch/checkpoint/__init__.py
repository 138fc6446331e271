"""Checkpointing with atomic commits and restart support (`ckpt`), in the
reference's on-disk layout, so either package restores the other's."""
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import latest_step, prune_old, restore, save

__all__ = ["ckpt", "latest_step", "prune_old", "restore", "save"]
