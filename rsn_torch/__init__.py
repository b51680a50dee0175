"""rsn_torch — the PyTorch / CUDA port of rsn, for one NVIDIA H100.

The JAX package `rsn` is the reference this package is held against.
This package imports torch and nothing of `rsn` or of rsn's tools/ (it
keeps its own copies of the jax-free configs, registry, config reader, SH
table, flag parser and matplotlib's turbo table), nor jax, flax, optax,
PIL or matplotlib.

Ported so far: the render path (eval-mode 4-pass `get_outputs`,
`render_image`, the orbit mode of the render CLI), the training path (the
training forward, the 8 losses, the optimizers, the trainer with its eval
hooks and the train CLI) for the default method, the proposal preset and
mipnerf, with pose refinement, on one device or data-parallel over
several, one rank each (`rsn_torch.parallel`); every field kernel of
rsn/kernels/ and the experiments of rsn's tools/
(`rsn_torch.experiments`), hand-written CUDA for sm_90a
(`rsn_torch/csrc/`).
"""
