"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

prtu    — K1, the entry-stream Mini-Tile CAT (csrc/prtu_entry.cu), and
          K4, the dense Mini-Tile CAT (csrc/prtu_dense.cu); both share
          Alg. 1's per-pair body (csrc/alg1.cuh)
render  — K2, the fused contribution-aware blend (csrc/blend_fused.cu),
          and K3, the full-sweep blend (csrc/blend_full.cu)
ref     — oracles: the dense CAT, the full sweep, the fused blend's counters
ops     — routing of the render pipeline through the kernels
build   — nvcc build of csrc/*.cu on first use, loaded with ctypes
"""
