#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsn_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. device   — the card, torch / CUDA versions, nvidia-smi name and
                power limit; TF32 off for fp32 matmuls and convolutions.
  2. build    — compiles rsn_torch/csrc/*.cu for sm_90a into
                rsn_torch/_build/, one nvcc per source, all at once (the
                first call of a checkout builds).
  3. kernels  — K1 (field_forward_v3) and K2 (field_forward_density)
                against their plain PyTorch versions on the card, on the
                real inputs of one 16384-ray chunk of the first 800x800
                orbit frame (passes 1-4), plus K2's density column
                against K1's, bit for bit, and CUDA-event times.
  4. cpu/gpu  — one 32x32 frame rendered on the CPU (plain versions) and
                on the card (kernels), product_only both ways.
  5. render   — `python -m rsn_torch.cli.render --mode orbit` on a run
                dir with seed-drawn weights (the registry's
                reflect-sampling-nerf config, compute_dtype bfloat16,
                synthetic sphere at 800x800); the kernels' launch counts
                of that run, then a 400x400 full (not product-only) render.
  6. train kernels — K3 (field_forward_v6), K5 (field_backward_v6) and K4
                (field_backward_v5) against their plain versions on the
                real inputs of one full-width train step (1024 rays, step
                50: the normal losses on), K3's density column against
                K1's, CUDA-event times.
  7. cpu/gpu step — one 64-ray train step with midpoint draws on the CPU
                (plain versions) and on the card (kernels): losses and
                every parameter gradient.
  8. train    — `python -m rsn_torch.cli.train reflect-sampling-nerf` for
                60 steps at full width on the synthetic sphere at 800x800:
                launches per step, finite and falling losses, the
                checkpoint; then one orbit frame of the trained run at
                downscale 4 through the render CLI.
  The proposal preset (reflect-sampling-nerf-proposal, bf16, with
  use_pallas_proposal set by its config flag):
  9. K9       — K9 (prop_forward) against its plain version on the card,
                on the real pass-1 and pass-3 inputs of the middle chunk of
                the first 800x800 preset orbit frame; CUDA-event times.
  10. cpu/gpu — one 32x32 preset frame on the CPU (plain versions) and on
                the card (kernels); one 64-ray preset train step on both:
                losses, and every gradient of field and proposal.
  11. preset train and render — `python -m rsn_torch.cli.train
                reflect-sampling-nerf-proposal` for 60 steps at full width
                (launches per step, finite and falling losses, the
                interlevel and distortion losses reported), then `python -m rsn_torch.cli.render --mode
                orbit` of that run at 800x800 (K9 and K1 launches, frames
                2-3 in rays/s); then the run's frames 2-3 with
                use_pallas_proposal on and off, both timed through
                render_image, for comparison.
  12. result  — the kernels' JSON line, then {"ok": true, "device": ...}.

Any failed check raises: the script then exits non-zero and prints no
result.  It imports neither jax nor PIL, nor anything of the JAX package.
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
TRAIN_STEPS = 60
GRAD_TOL = 5e-2     # bf16 chains of 8 layers: share of each tensor's max
LOSS_TOL = 2e-2     # relative, with an absolute floor of 1e-6 (zero losses)
PROP_TOL = 1e-2     # K9: share of max |preact| (bf16 activations, fp32 sums
                    # in another order: a rounding flip moves a row by an
                    # ulp of its activations)

# The card's peaks (NVIDIA's data sheet, H100 SXM, dense): bf16 tensor
# cores and HBM3.  A kernel's bound is the larger of its products over the
# first and the bytes it must move (each input read once, each output
# written once) over the second.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12   # float32 outside the tensor cores
# products per row, at the kernels' operand shapes (IPE padded to 128,
# as the packed weights are)
TRUNK_MACS = 128 * 256 + 3 * 256 * 256 + 384 * 256 + 3 * 256 * 256
DGRAD_MACS = TRUNK_MACS  # W^T through the 8 layers, x part included
PROP_IN = 6 * 8 + 3  # K9's IPE: 8 octaves of sin and cos of 3 dims, mean
FLOPS = {
    # trunk, heads + mid seed (16 + 128 columns), mid head
    "field_forward_v3": 2 * (TRUNK_MACS + 256 * 144 + 128 * 3),
    "field_forward_density": 2 * (TRUNK_MACS + 256),
    # K1, plus the normals dgrad when the normals are wanted
    "field_forward_v6": 2 * (TRUNK_MACS + 256 * 144 + 128 * 3),
    # mid seed recompute, mid-head wgrad/dgrad, heads+mid wgrad and
    # dgrad (144 live columns), 8 wgrads, the dgrads of layers 7..1
    # without layer 4's x part
    "field_backward_v6": 2 * (256 * 128 + 2 * 128 * 3 + 2 * 256 * 144
                              + TRUNK_MACS + DGRAD_MACS - 2 * 128 * 256),
    # K5 plus layer 4's x part and layer 0 (the IPE backward's dx)
    "field_backward_v5": 2 * (256 * 128 + 2 * 128 * 3 + 2 * 256 * 144
                              + TRUNK_MACS + DGRAD_MACS),
    # the 4 x 64 trunk on the IPE's live columns, and the 64 -> 1 head
    "prop_forward": 2 * (PROP_IN * 64 + 3 * 64 * 64 + 64),
}
# K9's IPE on the CUDA cores, counting a sine and an exp as one operation
# each: per sin/cos column the phase product (+ pi/2), the variance
# product, its halving, exp, sin and the damping product
PROP_FP32_OPS = 48 * 7
# K9's bytes: per row the 6 live f32 columns of its input (mean, cov) and
# its f32 output; once, the live weights (bf16) and biases (f32)
PROP_ROW_BYTES = 6 * 4 + 4
PROP_PARAM_BYTES = (2 * (PROP_IN * 64 + 3 * 64 * 64 + 64)
                    + 4 * (4 * 64 + 1))


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


def bound(flops: float, nbytes: float, fp32_ops: float = 0.0):
    """-> (least ms the card could take, "operations" or "bytes"): the
    larger of the tensor-core products over the bf16 peak, the float32
    operations over the float32 peak and the bytes over the memory rate."""
    t_ops = max(flops / PEAK_FLOPS, fp32_ops / PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def smoke_config(method: str = "reflect-sampling-nerf", **model_flags):
    from rsn_torch.cli.registry import get_method

    cfg = get_method(method).config_factory()
    model = dataclasses.replace(cfg.pipeline.model, compute_dtype="bfloat16",
                                **model_flags)
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
    paths, log = build_library()
    for source in paths:
        load_library(source)
    print(f"built {', '.join(os.path.relpath(p, REPO) for p in paths.values())}"
          f" in {time.perf_counter() - t0:.2f} s (one nvcc per source, in "
          f"parallel)")
    for line in log.splitlines():
        if re.search(r"^---|registers|spill", line):
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()

    from rsn_torch.cli import render as render_cli
    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.data.synthetic import load_cameras
    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.engine.trainer import render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models.field import Field

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
            b, by = bound(FLOPS["field_forward_v3"] * mc.shape[0],
                          nbytes(mc, g, *packed) + mc.shape[0] * 16 * 2)
            results["field_forward_v3"].update(ms=k, plain_ms=pl,
                                               bound_ms=b, bound_by=by)
    for p, (packed, mc) in zip((1, 3), calls["density"]):
        k = cuda_ms(lambda: ff.field_forward_density(packed, mc))
        pl = cuda_ms(lambda: ff.field_forward_density_plain(packed, mc))
        print(f"  K2 pass {p}: {mc.shape[0]} rows, kernel {k:.4f} ms, "
              f"plain {pl:.4f} ms (median of 10; {card})", flush=True)
        if p == 1:
            b, by = bound(FLOPS["field_forward_density"] * mc.shape[0],
                          nbytes(mc, *packed) + mc.shape[0] * 8 * 2)
            results["field_forward_density"].update(ms=k, plain_ms=pl,
                                                    bound_ms=b, bound_by=by)
    del calls
    torch.cuda.empty_cache()

    # ---- 4. CPU against GPU ----
    phase("phase 4: CPU (plain versions) against GPU (kernels), 32x32")
    for product_only in (True, False):
        cpu_gpu_render(config, (field_cpu, field), orbit, device,
                       f"product_only={product_only}", product_only)

    # ---- 5. the entry point ----
    phase(f"phase 5: rsn_torch.cli.render --mode orbit at "
          f"{FRAME_RES}x{FRAME_RES}")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        ckpt_lib.dump_config(run, config)
        ckpt_lib.save_checkpoint(os.path.join(run, "checkpoints"), 0,
                                 field_cpu)
        text, stats, all_launches = run_render_cli(
            run, os.path.join(tmp, "frames"), "--num-frames", "3")
        print(text, end="")
        launches = {k: all_launches[k] for k in RENDER_KERNELS}
        print(f"  launches in the CLI run: {all_launches}")
        if min(launches.values()) <= 0:
            raise RuntimeError("a kernel of the render path never launched")
        check_orbit_frames(os.path.join(tmp, "frames"), stats, card)

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

    # ---- 6-8. the training path ----
    train_results = train_phases(config, field, device, card)
    results.update(train_results["kernels"])
    launches.update(train_results["launches"])

    # ---- 9-11. the proposal preset ----
    preset_results = preset_phases(field, field_cpu, orbit, device, card)
    results.update(preset_results["kernels"])
    launches.update(preset_results["launches"])

    # ---- 12. result ----
    phase("phase 12: result")
    kernels = []
    for name, source, line in KERNEL_ROWS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"rsn_torch/csrc/{source}",
            "replaces": line,
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no single PyTorch call computes a fused field
            "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


RENDER_KERNELS = ("field_forward_v3", "field_forward_density")
TRAIN_KERNELS = ("field_forward_v6", "field_backward_v6",
                 "field_backward_v5")
KERNEL_ROWS = (
    ("field_forward_v3", "field_forward.cu",
     "rsn/kernels/field_pallas.py:512"),
    ("field_forward_density", "field_forward.cu",
     "rsn/kernels/field_pallas.py:626"),
    ("field_forward_v6", "field_train.cu",
     "rsn/kernels/field_pallas.py:794"),
    ("field_backward_v5", "field_train.cu",
     "rsn/kernels/field_train.py:516"),
    ("field_backward_v6", "field_train.cu",
     "rsn/kernels/field_train.py:608"),
    ("prop_forward", "proposal_forward.cu",
     "rsn/kernels/proposal_pallas.py:107"),
)


def cpu_gpu_render(config, fields, orbit, device, label: str,
                   product_only: bool = True, proposals=(None, None)):
    """Orbit frame 1 at 32x32 on the CPU (plain versions) and on the card
    (kernels): masks agree on >= 99% of rays, final_rgb within 0.05 where
    they agree.  fields / proposals: (CPU, GPU) pairs."""
    import numpy as np
    import torch

    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.models.model import final_rgb

    small = rescale_cameras(orbit, FRAME_RES / 32)
    outs = []
    for f, p, dev in zip(fields, proposals, (torch.device("cpu"), device)):
        # orbit frame 1: some of its rays reflect, some do not
        outs.append(render_image(
            f, small.to(dev), 1, config,
            rays_per_chunk=preferred_eval_chunk(config, dev),
            product_only=product_only, proposal=p))
    cpu, gpu = outs
    agree = cpu["mask"] == gpu["mask"]
    share = float(agree.mean())
    diff = np.abs(final_rgb(cpu) - final_rgb(gpu))[agree[..., 0]]
    print(f"  {label}: masks agree on {share:.4%} of rays (mask fraction "
          f"{cpu['mask'].mean():.4f}), final_rgb max |diff| "
          f"{diff.max():.6g} where they agree", flush=True)
    if share < 0.99 or diff.max() > 0.05:
        raise RuntimeError("CPU and GPU renders disagree")


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (one tensor)."""
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


def capture_train_inputs(trainer, step: int):
    """Run one train step at `step` and record every training kernel
    call's inputs: -> {"fwd": [...], "bwd5": [...], "bwd6": [...]} in
    call order (forward passes 1-4, then the backward of passes 4, 3
    (K4) and 2, 1 (K5))."""
    import torch

    from rsn_torch.kernels import field_train as ft

    calls = {"fwd": [], "bwd5": [], "bwd6": []}
    real = (ft.field_forward_v6, ft.field_backward_v5, ft.field_backward_v6)

    def fwd(packed, mc, g, S, want_normals=False, spill_x=False):
        calls["fwd"].append((tuple(packed), mc.clone(), g.clone(), S,
                             want_normals, spill_x))
        return real[0](packed, mc, g, S, want_normals, spill_x)

    def bwd5(packed, mc, g, acts, d_out, f_out, S):
        calls["bwd5"].append((tuple(packed), mc.clone(), g.clone(),
                              acts.clone(), d_out.clone(), f_out.clone(), S))
        return real[1](packed, mc, g, acts, d_out, f_out, S)

    def bwd6(packed, g, xacts, d_out, f_out, S):
        calls["bwd6"].append((tuple(packed), g.clone(), xacts.clone(),
                              d_out.clone(), f_out.clone(), S))
        return real[2](packed, g, xacts, d_out, f_out, S)

    ft.field_forward_v6, ft.field_backward_v5, ft.field_backward_v6 = (
        fwd, bwd5, bwd6)
    try:
        trainer.step = step
        trainer.train_step()
    finally:
        (ft.field_forward_v6, ft.field_backward_v5,
         ft.field_backward_v6) = real
    torch.cuda.synchronize()
    got = tuple(len(calls[k]) for k in ("fwd", "bwd5", "bwd6"))
    if got != (4, 2, 2):
        raise RuntimeError(f"expected 4 + 2 + 2 training kernel calls, "
                           f"got {got}")
    return calls


def check_normals(p, out, ref, acts, ref_acts, packed, mc) -> None:
    """K3's V4_DPDM columns (d density_preact / d mean).  Held against the
    plain dgrad chain on K3's own spilled activations: -normalize within
    cos 0.999 on every row with |dpdm| > 1e-3.  Against the whole plain
    forward the bf16 activations of a row may differ (a rounding flipped
    in layer 0 grows through the 8 layers), and with them the
    activations' masks: that share is reported."""
    import torch

    from rsn_torch.kernels import field_train as ft

    unit = lambda v: -torch.nn.functional.normalize(v.float(), dim=-1)
    chain = ft.normals_dgrad_plain(packed, ft._split_acts(acts), mc)
    live = chain.norm(dim=-1) > 1e-3
    cos = (unit(out[:, 14:17]) * unit(chain)).sum(-1)[live]
    nerr = float((unit(out[:, 14:17]) - unit(chain))[live].abs().max())
    alive = ref[:, 14:17].float().norm(dim=-1) > 1e-3
    cos_f = (unit(out[:, 14:17]) * unit(ref[:, 14:17])).sum(-1)[alive]
    print(f"  K3 pass {p} normals: against the plain dgrad on K3's "
          f"activations min cos {float(cos.min()):.8f} over {int(live.sum())}"
          f" live rows (limit 0.999), max |unit err| {nerr:.6g}; against "
          f"the whole plain forward cos >= 0.999 on "
          f"{float((cos_f >= 0.999).float().mean()):.6%} of rows")
    off = torch.zeros_like(alive)
    off[alive] = cos_f < 0.999
    if off.any():
        diff = (acts.float() != ref_acts.float()).sum(dim=-1).float()
        print(f"    the {int(off.sum())} rows below 0.999 differ from the "
              f"plain forward's activations in {float(diff[off].mean()):.4g}"
              f" of {acts.shape[1]} spilled entries on average (all rows "
              f"{float(diff.mean()):.4g})")
    if float(cos.min()) < 0.999:
        raise RuntimeError("K3's normals disagree with the plain dgrad")


def check_train_kernels(calls, card):
    """Phase 6's comparisons and times -> per-kernel results."""
    import torch

    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft

    results = {k: {"err": 0.0} for k in TRAIN_KERNELS}
    r = results["field_forward_v6"]
    for p, (packed, mc, g, S, wn, sx) in enumerate(calls["fwd"], start=1):
        out, acts = ft.field_forward_v6(packed, mc, g, S, wn, sx)
        ref, ref_acts = ft.field_forward_v6_plain(packed, mc, g, S, wn, sx)
        torch.cuda.synchronize()
        live = list(range(14)) + list(range(17, 20))
        err = compare(f"K3 pass {p} (S={S}, normals={wn}, spill_x={sx})",
                      out, ref, live)
        r["err"] = max(r["err"], err)
        ulp = ref_acts.float().abs().clamp_min(1e-30) * 2.0 ** -7
        share = float(((acts.float() - ref_acts.float()).abs() <= ulp)
                      .float().mean())
        print(f"  K3 pass {p}: spill {tuple(acts.shape)}, {share:.6%} of "
              f"entries within one bf16 ulp (limit 99.9%)")
        if share < 0.999:
            raise RuntimeError("K3's spill disagrees with its plain version")
        if wn:
            check_normals(p, out, ref, acts, ref_acts, packed, mc)
        if p == 2:
            k1 = ff.field_forward_v3(packed[:20], mc, g, S)
            if not torch.equal(out[:, 12], k1[:, 12]):
                raise RuntimeError("K3 column 12 differs from K1 column 12")
            e1 = float((out[:, :14].float() - k1[:, :14].float()).abs().max())
            print(f"  K3 density column == K1 column 12, bit for bit; "
                  f"columns 0:14 within {e1:.6g} of K1's (limit {ATOL})")
            if e1 > ATOL:
                raise RuntimeError("K3 and K1 disagree")
    for name, key, passes in (("field_backward_v5", "bwd5", (4, 3)),
                              ("field_backward_v6", "bwd6", (2, 1))):
        fn, plain = getattr(ft, name), getattr(ft, name + "_plain")
        tag = "K4" if key == "bwd5" else "K5"
        for p, args in zip(passes, calls[key]):
            got, ref = fn(*args), plain(*args)
            torch.cuda.synchronize()
            errs = {}
            if key == "bwd5":
                errs["dmc"] = rel_err(got[0], ref[0])
            errs["dg"] = rel_err(got[-2], ref[-2])
            errs["dpacked"] = max(rel_err(a, b)
                                  for a, b in zip(got[-1], ref[-1]))
            worst = max(errs.values())
            print(f"  {tag} pass {p}: rows {args[-2].shape[0]}, max error "
                  f"over each tensor's max: " + ", ".join(
                      f"{k} {v:.6g}" for k, v in errs.items())
                  + f" (limit {ATOL})", flush=True)
            if worst > ATOL:
                raise RuntimeError(f"{tag} disagrees with its plain version")
            results[name]["err"] = max(results[name]["err"], worst)

    # times and bounds: K3 on passes 2 and 4, K5 on pass 2, K4 on pass 4
    w_bytes = nbytes(*calls["fwd"][0][0][:20])
    for p in (2, 4):
        packed, mc, g, S, wn, sx = calls["fwd"][p - 1]
        n = mc.shape[0]
        k = cuda_ms(lambda: ft.field_forward_v6(packed, mc, g, S, wn, sx))
        pl = cuda_ms(lambda: ft.field_forward_v6_plain(packed, mc, g, S,
                                                       wn, sx))
        flops = (FLOPS["field_forward_v6"] + (2 * DGRAD_MACS if wn else 0)) * n
        acts_cols = ft.XACTS_COLS if sx else ft.ACTS_COLS
        b, by = bound(flops, nbytes(mc, g) + w_bytes
                      + n * (ft.OUT_TRAIN + acts_cols) * 2)
        print(f"  K3 pass {p}: {n} rows, kernel {k:.4f} ms, plain {pl:.4f} "
              f"ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        if p == 2:
            r.update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    for name, key, p in (("field_backward_v6", "bwd6", 2),
                         ("field_backward_v5", "bwd5", 4)):
        args = calls[key][0]
        fn, plain = getattr(ft, name), getattr(ft, name + "_plain")
        n = args[-2].shape[0]
        g = args[2] if key == "bwd5" else args[1]
        k = cuda_ms(lambda: fn(*args))
        pl = cuda_ms(lambda: plain(*args))
        ins = nbytes(*[a for a in args[1:] if isinstance(a, torch.Tensor)])
        outs = g.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + (
            n * 16 * 4 if key == "bwd5" else 0)
        b, by = bound(FLOPS[name] * n, ins + w_bytes + outs)
        tag = "K4" if key == "bwd5" else "K5"
        print(f"  {tag} pass {p}: {n} rows, kernel {k:.4f} ms, plain "
              f"{pl:.4f} ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        results[name].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    return results


def cpu_gpu_train_step(config, field_eval, device, proposal_eval=None,
                       step: int = 50):
    """One 64-ray step with midpoint draws on both devices, at `step`
    (the loss coefficients and the proposal's weight anneal); with
    proposal_eval (the preset) its gradients are compared too."""
    import copy

    import torch

    from rsn_torch.engine import trainer as trainer_lib
    from rsn_torch.models import model as model_lib

    mcfg = config.pipeline.model
    ds = trainer_lib.load_dataset("synthetic", f"sphere:res={FRAME_RES}",
                                  "train")
    bundle, gt = trainer_lib.sample_pixel_batch(
        torch.as_tensor(ds.images), ds.cameras, 64,
        torch.Generator().manual_seed(SEED))
    bundle = model_lib.apply_collider(bundle, mcfg)
    coeffs = trainer_lib.loss_coefficients(mcfg, step)
    anneal = trainer_lib.proposal_anneal(mcfg, step)
    step_out = []
    for dev in (torch.device("cpu"), device):
        f = copy.deepcopy(field_eval).to(dev)
        p = (None if proposal_eval is None
             else copy.deepcopy(proposal_eval).to(dev))
        b = dataclasses.replace(bundle, **{
            fl.name: (None if getattr(bundle, fl.name) is None
                      else getattr(bundle, fl.name).to(dev))
            for fl in dataclasses.fields(bundle)})
        outs = model_lib.get_outputs(f, b, mcfg, training=True,
                                     rays_live=False, proposal=p,
                                     prop_anneal=anneal)
        losses = model_lib.get_loss_dict(outs, gt.to(dev), coeffs)
        sum(losses.values()).backward()
        params = list(f.named_parameters()) + (
            [] if p is None else [(f"proposal.{k}", v)
                                  for k, v in p.named_parameters()])
        step_out.append(({k: float(v.detach()) for k, v in losses.items()},
                         {k: v.grad.cpu() for k, v in params
                          if v.grad is not None},
                         float(outs["mask"].float().mean())))
    (lc, gc, mfc), (lg, gg, mfg) = step_out
    worst_loss = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6 / LOSS_TOL)
                     for k in lc)
    worst_grad = max(rel_err(gg[k], gc[k]) for k in gc)
    print(f"  mask fraction CPU {mfc:.4f}, GPU {mfg:.4f}; {len(lc)} losses "
          f"within rel {worst_loss:.6g} (limit {LOSS_TOL}); {len(gc)} "
          f"parameter gradients within {worst_grad:.6g} of their max "
          f"(limit {GRAD_TOL})", flush=True)
    if set(gg) != set(gc) or worst_loss > LOSS_TOL or worst_grad > GRAD_TOL:
        raise RuntimeError("CPU and GPU train steps disagree")


def run_train_cli(card, method: str, flags, per_step, tmp,
                  report=("loss_mid_fine",)):
    """The train CLI for TRAIN_STEPS full-width steps of `method` on the
    sphere at FRAME_RES, from zeroed launch counts: every kernel's launches
    equal per_step x TRAIN_STEPS (absent kernels: zero), every logged loss
    finite, loss_mid_fine lower over the last 10 steps than over the first
    10, the warmup's zeros before step 50, the final checkpoint; the means
    of the `report` losses are printed.  -> (run dir, the kernels'
    launches)."""
    import numpy as np
    import torch

    from rsn_torch.cli import train as train_cli
    from rsn_torch.kernels import field_forward as ff

    argv = [method, "--data", f"sphere:res={FRAME_RES}",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16", *flags,
            "--max-num-iterations", str(TRAIN_STEPS),
            "--steps-per-log", "1", "--seed", str(SEED), "--output-dir", tmp]
    buf = io.StringIO()
    ff.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    text = buf.getvalue().splitlines()
    print("\n".join(text[:3] + ["  ..."] + text[-2:]))
    if rc != 0:
        raise RuntimeError(f"train CLI exited {rc}")
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    print(f"  launches in the CLI run: {launches}")
    if launches != want:
        raise RuntimeError(f"the train path's launches are not {want}")
    run = re.search(r"run dir: (\S+)", buf.getvalue()).group(1)
    with open(os.path.join(run, "train_log.jsonl")) as fh:
        log = [json.loads(line) for line in fh]
    if [e["step"] for e in log] != list(range(1, TRAIN_STEPS + 1)):
        raise RuntimeError("expected one log line per step")
    keys = [k for k in log[0] if k.startswith(
        ("loss", "predicted", "orientation", "interlevel", "distortion",
         "total"))]
    if not all(np.isfinite(e[k]) for e in log for k in keys):
        raise RuntimeError("a logged loss is not finite")
    means = {k: (float(np.mean([e[k] for e in log[:10]])),
                 float(np.mean([e[k] for e in log[-10:]])))
             for k in report}
    warm = all(e["orientation_loss_fine"] == 0 for e in log[:49])
    print(f"  {len(keys)} loss keys finite on every step; " + "; ".join(
        f"mean {k} steps 1-10 {a:.6g}, steps {TRAIN_STEPS - 9}-"
        f"{TRAIN_STEPS} {b:.6g}" for k, (a, b) in means.items())
        + f"; normal losses zero before step 50: {warm}; mask fraction at "
        f"the end {log[-1]['mask_fraction']:.4f}, reflect bucket "
        f"{log[-1]['reflect_fraction']}")
    early = float(np.mean([e["loss_mid_fine"] for e in log[:10]]))
    late = float(np.mean([e["loss_mid_fine"] for e in log[-10:]]))
    if not late < early:
        raise RuntimeError("loss_mid_fine did not fall")
    if not warm:
        raise RuntimeError("the warmup did not zero the normal losses")
    ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
    print(f"  checkpoints: {ckpts}")
    if ckpts != [f"step-{TRAIN_STEPS:09d}.pt"]:
        raise RuntimeError("expected the final checkpoint")
    rays_s = [e["rays_per_sec"] for e in log[10:]]
    print(f"  train throughput, steps 11-{TRAIN_STEPS}: median "
          f"{statistics.median(rays_s):.1f} rays/s (min "
          f"{min(rays_s):.1f}, max {max(rays_s):.1f}; {card})", flush=True)
    return run, {k: v for k, v in launches.items() if per_step.get(k)}


def check_orbit_frames(frames_dir, stats, card):
    """Three 800x800 frames: not constant, final_rgb in [0, 1] (the CLI
    checked them finite), a mixed reflection mask; prints frames 2-3's
    rays/s."""
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


def run_render_cli(run, frames_dir, *flags):
    """The render CLI's orbit mode on `run`, from zeroed launch counts ->
    (its stdout, the per-frame (s, rays/s, mask fraction, bucket, rgb lo,
    rgb hi), the kernels' launches)."""
    import torch

    from rsn_torch.cli import render as render_cli
    from rsn_torch.kernels import field_forward as ff

    buf = io.StringIO()
    ff.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = render_cli.main(["--load-dir", run, "--mode", "orbit",
                              "--output-dir", frames_dir, *flags])
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"render CLI exited {rc}")
    stats = [tuple(float(x) for x in m) for m in re.findall(
        r"rendered \d+/\d+: ([\d.]+) s, ([\d.]+) rays/s, mask fraction "
        r"([\d.]+), reflect bucket ([\d.]+), rgb range \[([-\d.e]+), "
        r"([-\d.e]+)\]", buf.getvalue())]
    return buf.getvalue(), stats, launches


def train_entry_point(card):
    """Phase 8: the train CLI for TRAIN_STEPS steps, then one orbit frame
    of the trained run -> the training kernels' launches of the run."""
    with tempfile.TemporaryDirectory() as tmp:
        run, launches = run_train_cli(
            card, "reflect-sampling-nerf", (),
            {"field_forward_v6": 4, "field_backward_v6": 2,
             "field_backward_v5": 2}, tmp)
        frames = os.path.join(tmp, "frames")
        text, _, _ = run_render_cli(run, frames, "--num-frames", "1",
                                    "--downscale-factor", "4")
        print(text, end="")
        px = png_pixels(os.path.join(frames, "frame_00000.png"))
        side = FRAME_RES // 4
        if px.shape != (side, side * 3) or px.min() == px.max():
            raise RuntimeError("the trained run's orbit frame failed")
    return launches


def train_phases(config, field, device, card):
    """Phases 6-8 -> {"kernels": per-kernel results, "launches": the
    training kernels' launches in the train CLI run}."""
    import torch

    from rsn_torch.engine import trainer as trainer_lib

    phase("phase 6: training kernels against plain versions at the shapes "
          "of one full-width train step")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_lib.Trainer(config, run_dir=os.path.join(tmp, "r"),
                                      device=device)
        trainer.field.load_state_dict(field.state_dict())
        calls = capture_train_inputs(trainer, 50)
        del trainer
    results = check_train_kernels(calls, card)
    del calls
    torch.cuda.empty_cache()

    phase("phase 7: one 64-ray train step with midpoint draws, CPU (plain "
          "versions) against GPU (kernels)")
    cpu_gpu_train_step(config, field, device)

    phase(f"phase 8: rsn_torch.cli.train reflect-sampling-nerf, "
          f"{TRAIN_STEPS} steps at full width, sphere at "
          f"{FRAME_RES}x{FRAME_RES}")
    launches = train_entry_point(card)
    return {"kernels": results, "launches": launches}


def capture_prop_inputs(field, proposal, cams, config, device):
    """The preset's get_outputs on the middle 16384-ray chunk of orbit
    frame 0, recording K9's inputs -> [(packed, mc)] for passes 1 and 3."""
    import torch

    from rsn_torch.core.rays import RayBundle
    from rsn_torch.data.cameras import generate_image_rays
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import proposal_forward as pf
    from rsn_torch.models import model as model_lib

    o, d, pa = generate_image_rays(cams, 0)
    mid = (o.shape[0] // CHUNK) // 2
    sl = slice(mid * CHUNK, (mid + 1) * CHUNK)
    zeros = torch.zeros_like(pa[sl])
    rb = model_lib.apply_collider(
        RayBundle(o[sl], d[sl], pa[sl], zeros, zeros), config.pipeline.model)
    calls = []
    real = pf.prop_forward

    def rec(packed, mc):
        calls.append((packed, mc.clone()))
        return real(packed, mc)

    pf.prop_forward = rec
    ff.reset_launch_counts()
    try:
        model_lib.get_outputs(field, rb, config.pipeline.model,
                              need_coarse_rgb=False, proposal=proposal)
    finally:
        pf.prop_forward = real
    torch.cuda.synchronize(device)
    k1, k2 = ff.LAUNCHES["field_forward_v3"], ff.LAUNCHES["field_forward_density"]
    if len(calls) != 2 or (k1, k2) != (2, 0):
        raise RuntimeError(f"a preset chunk ran K9 {len(calls)}x, K1 {k1}x, "
                           f"K2 {k2}x (want 2, 2, 0)")
    return calls


def check_prop_kernel(calls, card):
    """Phase 9's comparisons and times -> K9's results."""
    import torch

    from rsn_torch.kernels import proposal_forward as pf

    result = {"err": 0.0}
    for p, (packed, mc) in zip((1, 3), calls):
        got = pf.prop_forward(packed, mc)
        ref = pf.prop_forward_plain(packed, mc)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError("K9: non-finite kernel output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"  K9 pass {p}: rows {mc.shape[0]}, max |err| {err:.6g} of "
              f"max |preact| {scale:.6g} (limit {PROP_TOL} of it)",
              flush=True)
        if err > PROP_TOL * scale:
            raise RuntimeError("K9 disagrees with its plain version")
        result["err"] = max(result["err"], err)
    for p, (packed, mc) in zip((1, 3), calls):
        n = mc.shape[0]
        k = cuda_ms(lambda: pf.prop_forward(packed, mc))
        pl = cuda_ms(lambda: pf.prop_forward_plain(packed, mc))
        b, by = bound(FLOPS["prop_forward"] * n,
                      n * PROP_ROW_BYTES + PROP_PARAM_BYTES,
                      PROP_FP32_OPS * n)
        print(f"  K9 pass {p}: {n} rows, kernel {k:.4f} ms, plain {pl:.4f} "
              f"ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        if p == 1:
            result.update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    return result


def preset_phases(field, field_cpu, orbit, device, card):
    """Phases 9-11, the reflect-sampling-nerf-proposal preset with
    use_pallas_proposal -> {"kernels": K9's results, "launches": K9's
    launches in the render CLI run}."""
    import copy

    import torch

    from rsn_torch.models.proposal import ProposalField

    config = smoke_config("reflect-sampling-nerf-proposal",
                          use_pallas_proposal=True)
    prop_cpu = ProposalField(torch.Generator().manual_seed(SEED + 2)).eval()
    prop = copy.deepcopy(prop_cpu).to(device)

    phase("phase 9: K9 (prop_forward) against its plain version at the "
          "preset render's shapes")
    calls = capture_prop_inputs(field, prop, orbit.to(device), config,
                                device)
    result = check_prop_kernel(calls, card)
    del calls
    torch.cuda.empty_cache()

    phase("phase 10: the preset, CPU (plain versions) against GPU "
          "(kernels): a 32x32 frame, a 64-ray train step at step 100")
    cpu_gpu_render(config, (field_cpu, field), orbit, device,
                   "preset product frame", True, (prop_cpu, prop))
    cpu_gpu_train_step(config, field, device, prop, step=100)

    phase(f"phase 11: rsn_torch.cli.train reflect-sampling-nerf-proposal, "
          f"{TRAIN_STEPS} steps at full width, then rsn_torch.cli.render "
          f"--mode orbit of the run at {FRAME_RES}x{FRAME_RES}")
    with tempfile.TemporaryDirectory() as tmp:
        # the interlevel loss is reported, not required to fall: from a
        # random init it is 0 while the proposal's envelope covers the
        # field's spread fine weights, and grows as the field sharpens
        run, _ = run_train_cli(
            card, "reflect-sampling-nerf-proposal",
            ("--pipeline.model.use-pallas-proposal", "True"),
            {"field_forward_v6": 2, "field_backward_v6": 1,
             "field_backward_v5": 1}, tmp,
            ("loss_mid_fine", "interlevel_loss", "distortion_loss"))
        frames = os.path.join(tmp, "frames")
        text, stats, launches = run_render_cli(run, frames, "--num-frames",
                                               "3")
        print(text, end="")
        print(f"  launches in the CLI run: {launches}")
        chunks = -(-FRAME_RES * FRAME_RES // CHUNK)
        k9 = launches["prop_forward"]
        others = [launches[k] for k in ("field_forward_density",)
                  + TRAIN_KERNELS]
        if (k9 < 3 * 2 * chunks or k9 % (2 * chunks)
                or launches["field_forward_v3"] != k9 or any(others)):
            raise RuntimeError("a preset frame must run K9 and K1 twice per "
                               "chunk (passes 1, 3 and 2, 4) and nothing "
                               "else")
        print(f"  K9 and K1 each twice per chunk: {k9 // (2 * chunks)} "
              f"renders of {chunks} chunks for 3 frames (re-renders "
              f"included)")
        check_orbit_frames(frames, stats, card)

        compare_proposal_settings(run, orbit.to(device), device, card)
    return {"kernels": {"prop_forward": result},
            "launches": {"prop_forward": k9}}


def compare_proposal_settings(run, cams, device, card):
    """The run's orbit frames 2-3 with use_pallas_proposal on (K9) and off
    (the proposal's fp32 composition on passes 1 and 3), both timed the
    same way: render_image on the host clock, ending in a device sync,
    after frame 1 of each setting has set its bucket memo; in the order
    on, off, off, on.  Only K9's launches may differ between them."""
    import numpy as np
    import torch

    from rsn_torch.cli.run_io import load_run_full
    from rsn_torch.engine.trainer import render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models.model import final_rgb

    field, cfg, _, extras = load_run_full(run, device)
    cfgs = {on: dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, model=dataclasses.replace(
            cfg.pipeline.model, use_pallas_proposal=on)))
        for on in (True, False)}
    memo = {}
    kw = dict(rays_per_chunk=CHUNK, product_only=True, reflect_memo=memo,
              proposal=extras["proposal"])
    for on in (True, False):
        render_image(field, cams, 0, cfgs[on], **kw)
    rates = {True: [], False: []}
    for frame, on in ((1, True), (1, False), (2, False), (2, True)):
        ff.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render_image(field, cams, frame, cfgs[on], **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        k9 = ff.LAUNCHES["prop_forward"]
        if (k9 > 0) != on or not np.isfinite(final_rgb(out)).all():
            raise RuntimeError(f"frame {frame + 1} with use_pallas_proposal "
                               f"{on} failed (K9 launches {k9})")
        rates[on].append(FRAME_RES * FRAME_RES / seconds)
        print(f"  frame {frame + 1}, use_pallas_proposal {on}: {seconds:.4f}"
              f" s, {rates[on][-1]:.1f} rays/s, K9 launches {k9}")
    print(f"  frames 2-3 through render_image: use_pallas_proposal on "
          f"{statistics.mean(rates[True]):.1f} rays/s, off "
          f"{statistics.mean(rates[False]):.1f} rays/s (mean of 2 each; "
          f"{card})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
