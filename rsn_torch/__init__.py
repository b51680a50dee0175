"""rsn_torch — the PyTorch / CUDA port of rsn, for one NVIDIA H100.

The JAX package `rsn` is the reference this package is held against.
This package imports torch and nothing of `rsn` (it keeps its own copies
of the jax-free configs, registry, config reader, SH table and flag
parser), nor jax, flax, optax or PIL.

Ported so far: the render path (eval-mode 4-pass `get_outputs`,
`render_image`, the orbit mode of the render CLI) and the training path
(the training forward, the 8 losses, RAdam, the trainer and the train
CLI), with their five field kernels, hand-written CUDA for sm_90a
(`rsn_torch/csrc/`).
"""
