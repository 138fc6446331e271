"""The LM's synthetic token pipeline (`data.tokens`)."""
from repro_torch.data import tokens

__all__ = ["tokens"]
