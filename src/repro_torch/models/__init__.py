"""The LM substrate for every family: parameter specs, layers, GQA
attention with bf16 and int8 KV caches, MoE, MLA, the Mamba2 SSD mixer,
the blocks (checkpointed under autograd) and `Model` (`models.model`):
serving, and a differentiable loss for training, on one device or
tensor-parallel over a (pod, data, model) mesh; `models.parity` holds
two runs of one LM against each other."""
from repro_torch.models.model import Model

__all__ = ["Model"]
