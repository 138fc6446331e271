"""The LM substrate's serving path for the dense family: parameter specs,
layers, GQA attention with bf16 and int8 KV caches, the dense blocks and
`Model` (`models.model`)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
