"""K15: the port of tools/exp_interleave2.py.

field_forward_v3L (replaces exp_interleave2.py::field_forward_v3L) computes
K14's function (rsn_torch.experiments.interleave) with K1's IPE, the
wrapped phase and the polynomial sine (ipe_x).  On the card it runs K14's
Hopper block (rsn_torch/csrc/unfolded_sm90.cuh): the tool's two halves are
the block's two 64-row consumer warpgroups, and they take turns on the
tensor cores chunk by chunk through the trunk (each issues a chunk's
products once the other has issued its own, and passes the turn as soon as
they are issued, so one's epilogue runs under the other's products; the
ring lets one run at most STAGES - 1 chunks ahead); with `full` (the
tool's v3F) also through the heads and the mid seed.  The schedule is all
that `full` changes: the same bits either way, and the same bits as the
first design (experiments.cu under RSN_K14_FIRST_DESIGN).

The wrapper runs the plain version (field_forward_v3L_plain) for CPU
tensors and launches the CUDA kernel for CUDA tensors.

    python -m rsn_torch.experiments.interleave2 [N]

builds the first design beside the port and times K1 (field_forward_v3),
v3L, v3F and their first design on N rows (default 262,144, 128 samples
per ray) on the card.
"""
from __future__ import annotations

import sys

import torch

from rsn_torch.experiments.interleave import (first_design, launch_forward,
                                              time_variants, tool_inputs,
                                              unfolded_forward_plain)
from rsn_torch.kernels import field_forward as ff


def field_forward_v3L_plain(packed_v3, mean_cov: torch.Tensor,
                            g_bands: torch.Tensor,
                            samples_per_ray: int) -> torch.Tensor:
    """Plain PyTorch K15 (both schedules): K1's polynomial IPE, then the
    unfolded forward of K14."""
    return unfolded_forward_plain(packed_v3, ff.ipe_x(mean_cov), g_bands,
                                  samples_per_ray)


def field_forward_v3L(packed_v3, mean_cov: torch.Tensor,
                      g_bands: torch.Tensor, samples_per_ray: int,
                      full: bool = False) -> torch.Tensor:
    """K15: (N, 16) f32 + (R, 512) f32 -> (N, 128) bf16; full: the halves
    also take turns through the tail (counted as field_forward_v3F)."""
    return launch_forward("field_forward_v3F" if full else
                          "field_forward_v3L", "rsn_field_forward_v3L",
                          field_forward_v3L_plain, packed_v3, mean_cov,
                          g_bands, samples_per_ray, int(bool(full)))


def main(argv=None) -> int:
    """K1, v3L, v3F and their first design on the tool's rows: ms (median
    of 10 CUDA-event captures), TFLOP/s, each one's distance from v3L on
    columns 0:14, each variant against its first design."""
    argv = sys.argv[1:] if argv is None else argv
    n, S = (int(argv[0]) if argv else 262144), 128
    field, mc, g = tool_inputs(n, S)
    p3, p1 = ff.pack_params_v3(field), ff.pack_params_v3f(field)
    first = first_design()
    print(torch.cuda.get_device_name(0), flush=True)
    ref = field_forward_v3L(p3, mc, g, S)
    time_variants((
        ("v3", ff.field_forward_v3, (p1, mc, g, S), None),
        ("v3L", field_forward_v3L, (p3, mc, g, S, False),
         "field_forward_v3L"),
        ("v3F", field_forward_v3L, (p3, mc, g, S, True),
         "field_forward_v3F")), n, ref, "v3L", first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
