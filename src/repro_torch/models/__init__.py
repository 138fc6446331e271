"""The LM substrate's serving path for every family: parameter specs,
layers, GQA attention with bf16 and int8 KV caches, MoE, MLA, the Mamba2
SSD mixer, the blocks and `Model` (`models.model`)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
