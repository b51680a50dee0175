"""The port of rsn's experiments under tools/: each module holds the
kernels of one tool (hand-written CUDA: the forwards in
rsn_torch/csrc/experiments.cu, K18 and K19 in experiments_bwd.cu, K17 in
field_train.cu as K8's body on 128-row tiles), their plain PyTorch
versions, and a main() that times the variants on the card the way the
tool timed them on the TPU.

    python -m rsn_torch.experiments.interleave    # K14: v3u, v3i against K1
    python -m rsn_torch.experiments.interleave2   # K15: v3L, v3F against K1
    python -m rsn_torch.experiments.cheap_sin     # K16: eight elementwise modes
    python -m rsn_torch.experiments.bwd_whole     # K17: 128-row tiles against K8
    python -m rsn_torch.experiments.bwd_ablate    # K18: the backward's four modes
    python -m rsn_torch.experiments.bwd_noipe     # K19: from the spill, against K4
"""
