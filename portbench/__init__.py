"""The benchmark of the PyTorch/CUDA port of FLICKER (`repro_torch`).

`run.py` is its entry, `harness.py` one run of a cell; configurations,
traffic mixes and per-layer metric readers are files found by name
(`manifest.py`); `reference/` is the plain renderer that decides `correct`,
`work.py` the work counts behind the rooflines. Nothing here imports JAX or
the JAX package `repro`.
"""
