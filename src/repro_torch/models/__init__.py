"""The LM substrate for every family: parameter specs, layers, GQA
attention with bf16 and int8 KV caches, MoE, MLA, the Mamba2 SSD mixer,
the blocks (checkpointed under autograd) and `Model` (`models.model`):
serving, and a differentiable loss for training."""
from repro_torch.models.model import Model

__all__ = ["Model"]
