"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

prtu    — K1, the entry-stream Mini-Tile CAT (csrc/prtu_entry.cu)
render  — K2, the fused contribution-aware blend (csrc/blend_fused.cu)
ref     — the fused blend's counter oracle
ops     — routing of the render pipeline through the kernels
build   — nvcc build of csrc/*.cu on first use, loaded with ctypes
"""
