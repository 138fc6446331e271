"""Minitron 8B [arXiv:2407.14679]: pruned Nemotron, dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, mlp_act="relu2",
    microbatches=4,
)
