"""Optimizers of the LM train step (`optim.adamw`, `optim.adafactor`) and
gradient compression with error feedback (`optim.compression`), as the
reference's `repro/optim/`: plain functions on trees of tensors whose
states are NamedTuples of tensors."""
from repro_torch.optim import adafactor, adamw, compression

__all__ = ["adafactor", "adamw", "compression"]
