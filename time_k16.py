#!/usr/bin/env python3
"""K16's elementwise pass beside another checkout's and beside each mode's
one PyTorch call, on one CUDA card.

    python3 time_k16.py [CHECKOUT ...]

Builds rsn_torch/csrc/experiments.cu of this checkout (the port's build)
and of each CHECKOUT (a directory holding another commit of the repo, for
example unpacked from `git archive`), one nvcc each, in parallel, the
others into rsn_torch/_build/variants/ (git-ignored).  Then, for each of
K16's eight modes on the tool's (2,097,152, 128) f32 input
(cheap_sin.tool_input, seed chip_smoke.SEED), holds every build against
the plain version (chip_smoke's limits: copy bit for bit, poly_bf16 one
bf16 ulp, the others K16_TOL) and times every build (a direct launch of
rsn_cheap_sin) and the mode's one PyTorch call (chip_smoke.LIBRARY_CALLS)
in turns, four rounds, forwards and back: one call per event pair, and 5
calls back to back between two events (the device alone); CUDA events,
median of 10 each, the median of the four rounds.  Prints the card's name
and power limit.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 4


def main(argv) -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_k16.py needs a CUDA card")
    from chip_smoke import (K16_TOL, LIBRARY_CALLS, SEED, back_to_back_ms,
                            cuda_ms, library_calls)
    from rsn_torch.experiments import cheap_sin
    from rsn_torch.kernels.build import (finish_variants, load_library,
                                         start_variant)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    others = {os.path.basename(os.path.normpath(d)): start_variant(
        "experiments.cu", (), f"k16_{i}",
        csrc=os.path.join(os.path.abspath(d), "rsn_torch", "csrc"))
        for i, d in enumerate(argv)}
    try:
        libs = {"port": load_library("experiments.cu")}
    finally:
        built, _ = finish_variants(others)
    libs.update(built)
    dev = torch.device("cuda", 0)
    x = cheap_sin.tool_input(2097152, dev, seed=SEED)
    y = torch.empty_like(x)
    calls = library_calls(x)

    def launch(lib, mode):
        rc = lib.rsn_cheap_sin(x.data_ptr(), y.data_ptr(), x.shape[0],
                               cheap_sin.MODES.index(mode),
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"cheap_sin {mode}: launch failed ({rc})")
        return y

    print(f"K16 on {x.shape[0]} x 128 f32 ({card}); builds: "
          + ", ".join(["port (this checkout)"] + [
              f"{name} ({d})" for name, d in zip(others, argv)]), flush=True)
    for mode in cheap_sin.MODES:
        ref = cheap_sin.run_plain(mode, x)
        for name, lib in libs.items():
            got = launch(lib, mode)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            if mode == "copy":
                ok = torch.equal(got, ref)
            elif mode == "poly_bf16":
                ok = bool(torch.all(diff <= cheap_sin.bf16_ulp(ref)))
            else:
                ok = float(diff.max()) <= K16_TOL
            if not ok:
                raise RuntimeError(f"{name} {mode}: disagrees with the plain "
                                   "version")
            del diff
        del ref
        names = list(libs) + ["call"]
        fns = {name: (lambda lib=lib: launch(lib, mode))
               for name, lib in libs.items()}
        fns["call"] = calls[mode]
        one = {name: [] for name in names}
        dev_ms = {name: [] for name in names}
        for turn in range(ROUNDS):
            for name in (names if turn % 2 == 0 else names[::-1]):
                one[name].append(cuda_ms(fns[name]))
                dev_ms[name].append(back_to_back_ms(fns[name]))
        print(f"  {mode} (call: {LIBRARY_CALLS[mode]})", flush=True)
        for label, t in (("one call", one), ("back to back", dev_ms)):
            print(f"    {label:12}: " + ", ".join(
                f"{name} {statistics.median(v):.4f} ms ("
                + " / ".join(f"{u:.4f}" for u in v) + ")"
                for name, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
