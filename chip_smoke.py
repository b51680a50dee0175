#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsn_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. device   — the card, torch / CUDA versions, nvidia-smi name and
                power limit; TF32 off for fp32 matmuls and convolutions.
  2. build    — compiles rsn_torch/csrc/*.cu for sm_90a into
                rsn_torch/_build/ (the first call of a checkout builds).
  3. kernels  — K1 (field_forward_v3) and K2 (field_forward_density)
                against their plain PyTorch versions on the card, on the
                real inputs of one 16384-ray chunk of the first 800x800
                orbit frame (passes 1-4), plus K2's density column
                against K1's, bit for bit, and CUDA-event times.
  4. cpu/gpu  — one 32x32 frame rendered on the CPU (plain versions) and
                on the card (kernels), product_only both ways.
  5. entry    — `python -m rsn_torch.cli.render --mode orbit` on a run
                dir with seed-drawn weights (the registry's
                reflect-sampling-nerf config, compute_dtype bfloat16,
                synthetic sphere at 800x800); the kernels' launch counts
                of that run, then a 400x400 full (not product-only) render.
  6. result   — the kernels' JSON line, then {"ok": true, "device": ...}.

Any failed check raises: the script then exits non-zero and prints no
result.  It imports neither jax nor PIL.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 3            # field weights; its orbit frames mix reflecting rays
                    # and others (mask fraction strictly inside (0, 1))
FRAME_RES = 800     # Blender lego resolution
CHUNK = 16384       # rays per render chunk on a CUDA card
ATOL = 2e-2         # bf16 output: two ulps near 1
LIVE_V3 = list(range(14))
RGB_SLACK = 1e-4    # fp32 rounding of 1 - accumulation, the unmasked fill


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of `fn` over `reps` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def png_pixels(path: str):
    """(H, W * 3) uint8 pixels of a PNG written by rsn_torch.cli.render
    (8-bit RGB, filter type 0 on every row)."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if np.any(rows[:, 0] != 0):
        raise RuntimeError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:]


def smoke_config():
    from rsn.cli.registry import get_method

    cfg = get_method("reflect-sampling-nerf").config_factory()
    model = dataclasses.replace(cfg.pipeline.model, compute_dtype="bfloat16")
    dm = dataclasses.replace(cfg.pipeline.datamanager, dataparser="synthetic",
                             data=f"sphere:res={FRAME_RES}")
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, model=model, datamanager=dm))


def capture_kernel_inputs(field, cams, config, device):
    """Run get_outputs on the middle 16384-ray chunk of orbit frame 0 and
    record every kernel call's inputs: -> {"v3": [(packed, mc, g, S)] for
    passes 2 and 4, "density": [(packed, mc)] for passes 1 and 3}."""
    import torch

    from rsn_torch.core.rays import RayBundle
    from rsn_torch.data.cameras import generate_image_rays
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models import model as model_lib

    o, d, pa = generate_image_rays(cams, 0)
    mid = (o.shape[0] // CHUNK) // 2
    sl = slice(mid * CHUNK, (mid + 1) * CHUNK)
    zeros = torch.zeros_like(pa[sl])
    rb = model_lib.apply_collider(
        RayBundle(o[sl], d[sl], pa[sl], zeros, zeros), config.pipeline.model)
    calls = {"v3": [], "density": []}
    real_v3, real_dens = ff.field_forward_v3, ff.field_forward_density

    def rec_v3(packed, mc, g, S):
        calls["v3"].append((packed, mc.clone(), g.clone(), S))
        return real_v3(packed, mc, g, S)

    def rec_dens(packed, mc):
        calls["density"].append((packed, mc.clone()))
        return real_dens(packed, mc)

    ff.field_forward_v3, ff.field_forward_density = rec_v3, rec_dens
    try:
        model_lib.get_outputs(field, rb, config.pipeline.model,
                              need_coarse_rgb=False)
    finally:
        ff.field_forward_v3, ff.field_forward_density = real_v3, real_dens
    torch.cuda.synchronize(device)
    if len(calls["v3"]) != 2 or len(calls["density"]) != 2:
        raise RuntimeError(f"expected 2 + 2 kernel calls, got "
                           f"{len(calls['v3'])} + {len(calls['density'])}")
    return calls


def compare(name, got, ref, cols):
    import torch

    err = (got[:, cols].float() - ref[:, cols].float()).abs()
    if not torch.isfinite(got[:, cols].float()).all():
        raise RuntimeError(f"{name}: non-finite kernel output")
    mx = float(err.max())
    p999 = float(torch.quantile(err.flatten()[::max(1, err.numel() // 4_000_000)],
                                0.999))
    print(f"  {name}: rows {got.shape[0]}, max |err| {mx:.6g}, "
          f"99.9th pct {p999:.6g} (atol {ATOL})", flush=True)
    if mx > ATOL:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return mx


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "rsn_torch")):
        raise RuntimeError("chip_smoke.py runs from a checkout of the repo "
                           "(rsn_torch/ not found beside it)")
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    # ---- 1. device ----
    phase("phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device count "
          f"{torch.cuda.device_count()}")
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    phase("phase 2: build")
    from rsn_torch.kernels.build import build_library, load_library

    t0 = time.perf_counter()
    path, log = build_library()
    load_library()
    print(f"built {os.path.relpath(path, REPO)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if re.search(r"registers|spill", line):
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    from rsn_torch.cli import render as render_cli
    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.data.synthetic import load_cameras
    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models.field import Field
    from rsn_torch.models.model import final_rgb

    config = smoke_config()
    field_cpu = Field(torch.Generator().manual_seed(SEED)).eval()
    field = Field(torch.Generator().manual_seed(SEED)).to(device).eval()
    orbit = render_cli.orbit_cameras(
        load_cameras("synthetic", f"sphere:res={FRAME_RES}", "test"), 3)

    # ---- 3. kernels against their plain versions ----
    phase("phase 3: kernels against plain versions at main-path shapes")
    calls = capture_kernel_inputs(field, orbit.to(device), config, device)
    results = {"field_forward_v3": {"err": 0.0}, "field_forward_density":
               {"err": 0.0}}
    for p, (packed, mc, g, S) in zip((2, 4), calls["v3"]):
        got = ff.field_forward_v3(packed, mc, g, S)
        ref = ff.field_forward_v3_plain(packed, mc, g, S)
        err = compare(f"K1 pass {p} (S={S})", got, ref, LIVE_V3)
        results["field_forward_v3"]["err"] = max(
            results["field_forward_v3"]["err"], err)
        if p == 2:
            dens = ff.field_forward_density(
                ff.pack_params_density(field), mc)
            if not torch.equal(dens[:, 0], got[:, ff.V3_DENSITY]):
                raise RuntimeError("K2 column 0 differs from K1 column 12")
            print("  K2 density column == K1 column 12, bit for bit")
    for p, (packed, mc) in zip((1, 3), calls["density"]):
        got = ff.field_forward_density(packed, mc)
        ref = ff.field_forward_density_plain(packed, mc)
        err = compare(f"K2 pass {p}", got, ref, [0])
        if torch.any(got[:, 1:] != ref[:, 1:]):
            raise RuntimeError("K2 padding columns differ")
        results["field_forward_density"]["err"] = max(
            results["field_forward_density"]["err"], err)
    for p, (packed, mc, g, S) in zip((2, 4), calls["v3"]):
        k = cuda_ms(lambda: ff.field_forward_v3(packed, mc, g, S))
        pl = cuda_ms(lambda: ff.field_forward_v3_plain(packed, mc, g, S))
        print(f"  K1 pass {p}: {mc.shape[0]} rows, kernel {k:.4f} ms, "
              f"plain {pl:.4f} ms (median of 10; {card})", flush=True)
        if p == 2:
            results["field_forward_v3"].update(ms=k, plain_ms=pl)
    for p, (packed, mc) in zip((1, 3), calls["density"]):
        k = cuda_ms(lambda: ff.field_forward_density(packed, mc))
        pl = cuda_ms(lambda: ff.field_forward_density_plain(packed, mc))
        print(f"  K2 pass {p}: {mc.shape[0]} rows, kernel {k:.4f} ms, "
              f"plain {pl:.4f} ms (median of 10; {card})", flush=True)
        if p == 1:
            results["field_forward_density"].update(ms=k, plain_ms=pl)
    del calls
    torch.cuda.empty_cache()

    # ---- 4. CPU against GPU ----
    phase("phase 4: CPU (plain versions) against GPU (kernels), 32x32")
    small = rescale_cameras(orbit, FRAME_RES / 32)
    for product_only in (True, False):
        outs = []
        for f, dev in ((field_cpu, torch.device("cpu")), (field, device)):
            # orbit frame 1: some of its rays reflect, some do not
            outs.append(render_image(
                f, small.to(dev), 1, config,
                rays_per_chunk=preferred_eval_chunk(config, dev),
                product_only=product_only))
        cpu, gpu = outs
        agree = cpu["mask"] == gpu["mask"]
        share = float(agree.mean())
        diff = np.abs(final_rgb(cpu) - final_rgb(gpu))[agree[..., 0]]
        print(f"  product_only={product_only}: masks agree on "
              f"{share:.4%} of rays (mask fraction {cpu['mask'].mean():.4f}),"
              f" final_rgb max |diff| {diff.max():.6g} where they agree",
              flush=True)
        if share < 0.99 or diff.max() > 0.05:
            raise RuntimeError("CPU and GPU renders disagree")

    # ---- 5. the entry point ----
    phase(f"phase 5: rsn_torch.cli.render --mode orbit at "
          f"{FRAME_RES}x{FRAME_RES}")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        ckpt_lib.dump_config(run, config)
        ckpt_lib.save_checkpoint(os.path.join(run, "checkpoints"), 0,
                                 field_cpu)
        frames_dir = os.path.join(tmp, "frames")
        buf = io.StringIO()
        ff.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = render_cli.main(["--load-dir", run, "--mode", "orbit",
                                  "--num-frames", "3", "--output-dir",
                                  frames_dir])
        torch.cuda.synchronize()
        launches = dict(ff.LAUNCHES)
        print(buf.getvalue(), end="")
        if rc != 0:
            raise RuntimeError(f"render CLI exited {rc}")
        print(f"  launches in the CLI run: {launches}")
        if min(launches.values()) <= 0:
            raise RuntimeError("a kernel of the render path never launched")
        stats = [tuple(float(x) for x in m) for m in re.findall(
            r"rendered \d+/\d+: ([\d.]+) s, ([\d.]+) rays/s, mask fraction "
            r"([\d.]+), reflect bucket ([\d.]+), rgb range \[([-\d.e]+), "
            r"([-\d.e]+)\]", buf.getvalue())]
        if len(stats) != 3:
            raise RuntimeError("expected three rendered frames")
        for i in range(3):
            px = png_pixels(os.path.join(frames_dir, f"frame_{i:05d}.png"))
            if px.shape != (FRAME_RES, FRAME_RES * 3) or px.min() == px.max():
                raise RuntimeError(f"frame {i}: wrong size or constant")
        lo, hi = min(s[4] for s in stats), max(s[5] for s in stats)
        if lo < -RGB_SLACK or hi > 1.0 + RGB_SLACK:
            raise RuntimeError(f"final_rgb outside [0, 1]: [{lo}, {hi}]")
        mask_frac = sum(s[2] for s in stats) / 3
        print(f"  frames finite (checked by the CLI), final_rgb in "
              f"[{lo:.9g}, {hi:.9g}] (limit [0, 1] +- {RGB_SLACK}), not "
              f"constant; mask fraction over the frames {mask_frac:.6f}")
        if not 0.0 < mask_frac < 1.0:
            raise RuntimeError("degenerate reflection mask")
        rays_s = [s[1] for s in stats[1:]]
        print(f"  product frames 2-3 at {FRAME_RES}x{FRAME_RES}: "
              f"{rays_s[0]:.1f} and {rays_s[1]:.1f} rays/s; eval reflect "
              f"bucket after the run {stats[-1][3]} ({card})", flush=True)

    half = rescale_cameras(orbit, 2.0).to(device)
    ff.reset_launch_counts()
    render_image(field, half, 0, config, rays_per_chunk=CHUNK,
                 product_only=False)
    torch.cuda.synchronize()
    chunks = -(-half.width * half.height // CHUNK)
    print(f"  full render {half.width}x{half.height} ({chunks} chunks): "
          f"launches {dict(ff.LAUNCHES)}")
    if (ff.LAUNCHES["field_forward_v3"] != 4 * chunks
            or ff.LAUNCHES["field_forward_density"] != 0):
        raise RuntimeError("a full render must run K1 on all four passes "
                           "and K2 on none")

    # ---- 6. result ----
    phase("phase 6: result")
    kernels = []
    for name, line in (("field_forward_v3", 512),
                       ("field_forward_density", 626)):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rsn_torch/csrc/field_forward.cu",
            "replaces": f"rsn/kernels/field_pallas.py:{line}",
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
