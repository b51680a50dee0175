"""The port of rsn's forward experiments under tools/: each module holds
the kernels of one tool (hand-written CUDA, rsn_torch/csrc/experiments.cu),
their plain PyTorch versions, and a main() that times the variants on the
card the way the tool timed them on the TPU.

    python -m rsn_torch.experiments.interleave    # K14: v3u, v3i against K1
    python -m rsn_torch.experiments.interleave2   # K15: v3L, v3F against K1
    python -m rsn_torch.experiments.cheap_sin     # K16: eight elementwise modes
"""
