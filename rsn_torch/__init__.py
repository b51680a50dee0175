"""rsn_torch — the PyTorch / CUDA port of rsn, for one NVIDIA H100.

The JAX package `rsn` is the reference this package is held against.
This package imports torch and never jax; from `rsn` it imports only the
jax-free modules (`rsn.configs`, `rsn.cli.registry`,
`rsn.cli.run_io.load_config`, `rsn.core._sh_table`).

Ported so far: the render path (eval-mode 4-pass `get_outputs`,
`render_image`, the orbit mode of the render CLI) and its two field
kernels, hand-written CUDA for sm_90a (`rsn_torch/csrc/`).
"""
