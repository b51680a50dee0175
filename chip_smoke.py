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
  Pose refinement (camera_optimizer SO3xR3) and the recompute route
  (use_pallas_acts False), on the default method:
  12. recompute kernels — K7 (field_forward_v4), K1 at the train width
                (field_forward_v3_train) and K8 (field_backward_v4)
                against their plain versions on the real inputs of one
                full-width camera-on train step (step 50); K7 and K1's
                outputs against K3's, K8's against K4's on K3's spill, bit
                for bit; CUDA-event times; the peak device memory of one
                full-width step on each route, camera off and on.
  13. cpu/gpu camera step — one 64-ray camera-on step on the CPU (plain
                versions) and on the card (kernels), on both routes:
                losses, field gradients and pose-delta gradients.
  14. camera train — `python -m rsn_torch.cli.train reflect-sampling-nerf
                --pipeline.datamanager.camera-optimizer SO3xR3
                --pipeline.model.use-pallas-acts False` for 60 full-width
                steps (launches per step, falling losses, moving deltas in
                the checkpoint), then one 800x800 orbit frame of the run.
  15. pose recovery — rsn's protocol (tests/test_camera_opt_recovery.py)
                in bf16 on K7 / K1 / K8: the deltas must pull perturbed
                rays back toward the true ones.
  The field API and the schedule variants:
  16. K10-K13 — the slice's path from zeroed launch counts: K11
                (field_forward_v2) through Field.get_field_outputs(
                use_pallas=True, differentiable=False) on phase 3's pass-2
                render chunk (2,097,152 rows), K12 (field_forward) on the
                IPE encoding of the same rows, K10 (field_forward_v5) with
                both flags and K13 (field_backward_v3) on phase 12's
                camera-on inputs (passes 2 and 4); each against its plain
                version; K10 == K7 and K1 at the train width, K13 == K8 on
                dmc and dg, bit for bit, K13 the same twice and within 1e-4
                of K8's weight gradients; CUDA-event times, K10 beside K7
                and K1, K13 beside K8.
  17. result  — the kernels' JSON line, then {"ok": true, "device": ...}.

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
K8_TOL = 1e-1       # K8 against its plain version, which recomputes its own
                    # trunk: ~0.13% of the bf16 activations differ by an ulp
                    # (fp32 sums in another order) and move whole rays' dg
                    # (6.1e-2 of its max measured at random cotangents);
                    # against the plain K4 on K3's spill (= K8's recompute,
                    # bit for bit) K8 is held to ATOL
K13_TOL = 1e-4      # K13's weight gradients against K8's, of each tensor's
                    # max: the same slices summed in another fp32 order
DELTA_TOL = 1e-1    # pose-delta gradients, CPU against card: rsn's own bf16
                    # kernel branch is 6.1e-2 from its fp32 gradient
                    # (tests/test_torch_camera_opt.py)
CAMERA_FLAGS = ("--pipeline.datamanager.camera-optimizer", "SO3xR3",
                "--pipeline.model.use-pallas-acts", "False")

# The card's peaks (NVIDIA's data sheet, H100 SXM, dense): bf16 tensor
# cores and HBM3.  A kernel's bound is the larger of its products over the
# first and the bytes it must move (each input read once, each output
# written once) over the second.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12   # float32 outside the tensor cores
# products per row, on the IPE's 99 live columns: the packed weights pad
# layer 0 and layer 4's x part to 128 rows with zeros, which no function
# needs to multiply
IPE_DIM = 99
TRUNK_MACS = (IPE_DIM * 256 + 3 * 256 * 256 + (IPE_DIM + 256) * 256
              + 3 * 256 * 256)
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
                              + TRUNK_MACS + DGRAD_MACS
                              - 2 * IPE_DIM * 256),
    # K5 plus layer 4's x part and layer 0 (the IPE backward's dx)
    "field_backward_v5": 2 * (256 * 128 + 2 * 128 * 3 + 2 * 256 * 144
                              + TRUNK_MACS + DGRAD_MACS),
    # K4 plus the trunk forward again
    "field_backward_v4": 2 * (256 * 128 + 2 * 128 * 3 + 2 * 256 * 144
                              + 2 * TRUNK_MACS + DGRAD_MACS),
    # the 4 x 64 trunk on the IPE's live columns, and the 64 -> 1 head
    "prop_forward": 2 * (PROP_IN * 64 + 3 * 64 * 64 + 64),
    # the trunk and the (256, 267) live heads, bottleneck included; K12's
    # encoding columns 99..127 meet the zero rows of layers 0 and 4
    "field_forward_v2": 2 * (TRUNK_MACS + 256 * 267),
    "field_forward": 2 * (TRUNK_MACS + 256 * 267),
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
    render_mc = calls["v3"][0][1]  # pass 2's rows, for phase 16
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

    # ---- 12-15. pose refinement and the recompute route ----
    camera_results = camera_phases(config, field, device, card)
    results.update(camera_results["kernels"])
    launches.update(camera_results["launches"])

    # ---- 16. the field API and the schedule variants ----
    api_results = api_phase(field, render_mc, camera_results["calls"], card)
    results.update(api_results["kernels"])
    launches.update(api_results["launches"])

    # ---- 17. result ----
    phase("phase 17: result")
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
    ("field_forward_v4", "field_train.cu",
     "rsn/kernels/field_pallas.py:691"),
    ("field_forward_v3_train", "field_train.cu",
     "rsn/kernels/field_pallas.py:512"),
    ("field_backward_v4", "field_train.cu",
     "rsn/kernels/field_train.py:427"),
    ("field_forward_v5", "field_train.cu",
     "rsn/kernels/field_pallas.py:945"),
    ("field_forward_v2", "field_forward.cu",
     "rsn/kernels/field_pallas.py:182"),
    ("field_forward", "field_forward.cu",
     "rsn/kernels/field_pallas.py:217"),
    ("field_backward_v3", "field_train.cu",
     "rsn/kernels/field_train.py:353"),
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


def check_normals(p, out, ref, acts, ref_acts, packed, mc,
                  tag: str = "K3") -> None:
    """K3's (or K7's) V4_DPDM columns (d density_preact / d mean), held
    against the plain dgrad chain on K3's own spilled activations, on the
    rows with |dpdm| > 1e-3: -normalize within cos 0.999 on all but 1e-4
    of them and within 0.99 on every one.  The chain rounds each layer's
    dpre to bf16 after fp32 sums taken in another order, so a row whose
    gradient cancels heavily can turn by a degree or two (one row of
    131,072 at cos 0.9986 on the camera-on step's pass 2).  Against the
    whole plain forward the bf16 activations of a row may differ (a
    rounding flipped in layer 0 grows through the 8 layers), and with
    them the activations' masks: that share is reported."""
    import torch

    from rsn_torch.kernels import field_train as ft

    unit = lambda v: -torch.nn.functional.normalize(v.float(), dim=-1)
    chain = ft.normals_dgrad_plain(packed, ft._split_acts(acts), mc)
    live = chain.norm(dim=-1) > 1e-3
    cos = (unit(out[:, 14:17]) * unit(chain)).sum(-1)[live]
    nerr = float((unit(out[:, 14:17]) - unit(chain))[live].abs().max())
    below = int((cos < 0.999).sum())
    mag = chain.norm(dim=-1)[live]
    alive = ref[:, 14:17].float().norm(dim=-1) > 1e-3
    cos_f = (unit(out[:, 14:17]) * unit(ref[:, 14:17])).sum(-1)[alive]
    print(f"  {tag} pass {p} normals: against the plain dgrad on K3's "
          f"activations min cos {float(cos.min()):.8f} over {int(live.sum())}"
          f" live rows, {below} below 0.999 (limits 0.99, and 0.999 on all "
          f"but 1e-4 of the rows; the worst row's |dpdm| "
          f"{float(mag[int(cos.argmin())]):.6g}, the median "
          f"{float(mag.median()):.6g}), max |unit err| {nerr:.6g}; against "
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
    if float(cos.min()) < 0.99 or below > 1e-4 * int(live.sum()):
        raise RuntimeError(f"{tag}'s normals disagree with the plain dgrad")


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
                       step: int = 50, camera: bool = False):
    """One 64-ray step with midpoint draws on both devices, at `step`
    (the loss coefficients and the proposal's weight anneal); with
    proposal_eval (the preset) its gradients are compared too; with
    camera, pose deltas (0.01 x a seeded normal) move the rays and their
    gradients (the trainer's routed backward) are compared too."""
    import copy

    import torch

    from rsn_torch.engine import trainer as trainer_lib
    from rsn_torch.models import camera_opt
    from rsn_torch.models import model as model_lib

    mcfg = config.pipeline.model
    dm = config.pipeline.datamanager
    ds = trainer_lib.load_dataset("synthetic", f"sphere:res={FRAME_RES}",
                                  "train")
    bundle, gt = trainer_lib.sample_pixel_batch(
        torch.as_tensor(ds.images), ds.cameras, 64,
        torch.Generator().manual_seed(SEED))
    bundle = model_lib.apply_collider(bundle, mcfg)
    coeffs = trainer_lib.loss_coefficients(mcfg, step)
    anneal = trainer_lib.proposal_anneal(mcfg, step)
    deltas = 0.01 * torch.randn(ds.cameras.num_cameras, 6,
                                generator=torch.Generator().manual_seed(SEED))
    step_out = []
    for dev in (torch.device("cpu"), device):
        f = copy.deepcopy(field_eval).to(dev)
        p = (None if proposal_eval is None
             else copy.deepcopy(proposal_eval).to(dev))
        cam = torch.nn.Parameter(deltas.to(dev)) if camera else None
        b = dataclasses.replace(bundle, **{
            fl.name: (None if getattr(bundle, fl.name) is None
                      else getattr(bundle, fl.name).to(dev))
            for fl in dataclasses.fields(bundle)})
        b = camera_opt.apply_to_bundle(b, cam, "SO3xR3" if camera else "off")
        outs = model_lib.get_outputs(f, b, mcfg, training=True,
                                     rays_live=camera, proposal=p,
                                     prop_anneal=anneal)
        losses = model_lib.get_loss_dict(outs, gt.to(dev), coeffs)
        params = list(f.named_parameters()) + (
            [] if p is None else [(f"proposal.{k}", v)
                                  for k, v in p.named_parameters()])
        if camera:
            losses[trainer_lib.CAMERA_REG_KEY] = camera_opt.regularization_loss(
                cam, dm.camera_opt_rot_penalty, dm.camera_opt_trans_penalty)
        trainer_lib.routed_backward(losses, [v for _, v in params], cam)
        grads = {k: v.grad.cpu() for k, v in params if v.grad is not None}
        step_out.append(({k: float(v.detach()) for k, v in losses.items()},
                         grads, float(outs["mask"].float().mean()),
                         None if cam is None else cam.grad.cpu()))
    (lc, gc, mfc, dc), (lg, gg, mfg, dgpu) = step_out
    worst_loss = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-6 / LOSS_TOL)
                     for k in lc)
    worst_grad = max(rel_err(gg[k], gc[k]) for k in gc)
    delta_err = 0.0 if dc is None else rel_err(dgpu, dc)
    print(f"  mask fraction CPU {mfc:.4f}, GPU {mfg:.4f}; {len(lc)} losses "
          f"within rel {worst_loss:.6g} (limit {LOSS_TOL}); {len(gc)} "
          f"parameter gradients within {worst_grad:.6g} of their max "
          f"(limit {GRAD_TOL})" + ("" if dc is None else
                                   f"; pose-delta gradients within "
                                   f"{delta_err:.6g} of their max (limit "
                                   f"{DELTA_TOL}, max {float(dc.abs().max()):.6g})"),
          flush=True)
    if (set(gg) != set(gc) or worst_loss > LOSS_TOL or worst_grad > GRAD_TOL
            or delta_err > DELTA_TOL
            or (dc is not None and not float(dc.abs().max()) > 0)):
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


# ---- pose refinement and the recompute route ------------------------------

RECOMPUTE_KERNELS = ("field_forward_v4", "field_forward_v3_train",
                     "field_backward_v4")


def with_route(config, camera: bool, use_pallas_acts: bool):
    """`config` with the camera optimizer on or off and the given route."""
    dm = dataclasses.replace(config.pipeline.datamanager,
                             camera_optimizer="SO3xR3" if camera else "off")
    model = dataclasses.replace(config.pipeline.model,
                                use_pallas_acts=use_pallas_acts)
    return dataclasses.replace(config, pipeline=dataclasses.replace(
        config.pipeline, datamanager=dm, model=model))


def capture_recompute_inputs(trainer, step: int):
    """Run one camera-on recompute-route train step at `step` and record
    the kernels' calls: -> {"fwd": {pass: (packed, mc, g, S, out)},
    "bwd": {pass: (packed, mc, g, d_out, f_out, S)}} for passes 1-4, the
    backward calls of the first of the step's two backward passes (each
    matched to its pass by the forward output it differentiates)."""
    import torch

    from rsn_torch.kernels import field_train as ft

    fwd, bwd = [], []
    real = (ft.field_forward_v4, ft.field_forward_v3_train,
            ft.field_backward_v4)

    # clones: the packed biases share the parameters' storage, which the
    # optimizer step then updates in place
    def recording(forward):
        def fn(packed, mc, g, S):
            out = forward(packed, mc, g, S)
            fwd.append((tuple(t.clone() for t in packed), mc.clone(),
                        g.clone(), S, out.clone()))
            return out
        return fn

    def k8(packed, mc, g, d_out, f_out, S):
        bwd.append((tuple(t.clone() for t in packed), mc.clone(), g.clone(),
                    d_out.clone(), f_out.clone(), S))
        return real[2](packed, mc, g, d_out, f_out, S)

    ft.field_forward_v4, ft.field_forward_v3_train, ft.field_backward_v4 = (
        recording(real[0]), recording(real[1]), k8)
    try:
        trainer.step = step
        trainer.train_step()
    finally:
        (ft.field_forward_v4, ft.field_forward_v3_train,
         ft.field_backward_v4) = real
    torch.cuda.synchronize()
    if (len(fwd), len(bwd)) != (4, 8):
        raise RuntimeError(f"expected 4 forward and 8 K8 calls (two backward "
                           f"passes), got {len(fwd)} and {len(bwd)}")
    calls = {"fwd": dict(enumerate(fwd, start=1)), "bwd": {}}
    for args in bwd[:4]:
        p = next(q for q, f in calls["fwd"].items() if f[4].shape ==
                 args[4].shape and torch.equal(f[4], args[4]))
        calls["bwd"][p] = args
    if sorted(calls["bwd"]) != [1, 2, 3, 4]:
        raise RuntimeError("K8's calls do not match the four passes")
    return calls


def same_grads(a, b) -> bool:
    """(dmc, dg, 20 weight gradients) equal bit for bit."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def check_recompute_kernels(calls, card):
    """Phase 12's comparisons and times -> per-kernel results."""
    import torch

    from rsn_torch.kernels import field_train as ft

    results = {k: {"err": 0.0} for k in RECOMPUTE_KERNELS}
    for p in (2, 4):
        packed, mc, g, S, out = calls["fwd"][p]
        normals = p <= 2
        name = "field_forward_v4" if normals else "field_forward_v3_train"
        tag = "K7" if normals else "K1 train width"
        got = getattr(ft, name)(packed, mc, g, S)
        ref = ft.field_forward_v4_plain(packed, mc, g, S, normals)
        k3, acts = ft.field_forward_v6(packed, mc, g, S, normals)
        torch.cuda.synchronize()
        if not (torch.equal(got, out) and torch.equal(got, k3)):
            raise RuntimeError(f"{tag} pass {p} differs from K3's output")
        print(f"  {tag} pass {p}: the step's output == this call's == K3's "
              f"(normals={normals}), bit for bit")
        live = list(range(14)) + list(range(17, 20))
        err = compare(f"{tag} pass {p} (S={S})", got, ref, live)
        results[name]["err"] = max(results[name]["err"], err)
        if normals:
            _, ref_acts = ft.field_forward_v6_plain(packed, mc, g, S, True)
            check_normals(p, got, ref, acts, ref_acts, packed, mc, tag)
        bpacked, bmc, bg, d_out, f_out, bS = calls["bwd"][p]
        k8 = ft.field_backward_v4(bpacked, bmc, bg, d_out, f_out, bS)
        k8b = ft.field_backward_v4(bpacked, bmc, bg, d_out, f_out, bS)
        k4 = ft.field_backward_v5(bpacked, bmc, bg, acts, d_out, f_out, bS)
        torch.cuda.synchronize()
        if not same_grads(k8, k4) or not same_grads(k8, k8b):
            raise RuntimeError(f"K8 pass {p} differs from K4 on K3's spill or "
                               "from itself")
        plain = ft.field_backward_v4_plain(bpacked, bmc, bg, d_out, f_out, bS)
        on_spill = ft.field_backward_v5_plain(bpacked, bmc, bg, acts, d_out,
                                              f_out, bS)
        errs = {}
        for label, r in (("plain K8", plain), ("plain K4 on K3's spill",
                                                on_spill)):
            errs[label] = {"dmc": rel_err(k8[0], r[0]),
                           "dmc cov": rel_err(k8[0][:, 3:6], r[0][:, 3:6]),
                           "dg": rel_err(k8[1], r[1]),
                           "dpacked": max(rel_err(a, b)
                                          for a, b in zip(k8[2], r[2]))}
        _, plain_acts = ft.field_forward_v6_plain(bpacked, bmc, bg, bS)
        flips = float((acts != plain_acts).float().mean())
        print(f"  K8 pass {p}: rows {bmc.shape[0]}, == K4 on K3's spill and "
              f"== itself, bit for bit; max error over each tensor's max: "
              + "; ".join(f"against the {k}: " + ", ".join(
                  f"{n} {v:.6g}" for n, v in e.items())
                  for k, e in errs.items())
              + f" (limits {K8_TOL} and {ATOL}; {flips:.4%} of the plain "
              f"trunk's bf16 activations differ from the kernel's)",
              flush=True)
        worst = max(errs["plain K8"].values())
        if worst > K8_TOL or max(errs["plain K4 on K3's spill"].values()) > ATOL:
            raise RuntimeError("K8 disagrees with its plain version")
        results["field_backward_v4"]["err"] = max(
            results["field_backward_v4"]["err"], worst)

    # times and bounds: K7 on pass 2, K1 at the train width on pass 4, K8 on
    # passes 2 and 4 (K4 beside it on pass 4, on K3's spill)
    w_bytes = nbytes(*calls["fwd"][1][0][:20])
    for p, name in ((2, "field_forward_v4"), (4, "field_forward_v3_train")):
        packed, mc, g, S, _ = calls["fwd"][p]
        n = mc.shape[0]
        fn = getattr(ft, name)
        normals = name == "field_forward_v4"
        k = cuda_ms(lambda: fn(packed, mc, g, S))
        pl = cuda_ms(lambda: ft.field_forward_v4_plain(packed, mc, g, S,
                                                       normals))
        flops = (FLOPS["field_forward_v6"] + (2 * DGRAD_MACS if normals
                                              else 0)) * n
        b, by = bound(flops, nbytes(mc, g, *packed[20:]) + w_bytes
                      + n * ft.OUT_TRAIN * 2)
        tag = "K7" if normals else "K1 train width"
        print(f"  {tag} pass {p}: {n} rows, kernel {k:.4f} ms, plain "
              f"{pl:.4f} ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        results[name].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    for p in (4, 2):
        args = calls["bwd"][p]
        packed, mc, g, d_out, f_out, S = args
        n = mc.shape[0]
        k = cuda_ms(lambda: ft.field_backward_v4(*args))
        pl = cuda_ms(lambda: ft.field_backward_v4_plain(*args))
        outs = g.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + n * 16 * 4
        b, by = bound(FLOPS["field_backward_v4"] * n,
                      nbytes(mc, g, d_out, f_out) + w_bytes + outs)
        _, acts = ft.field_forward_v6(packed, mc, g, S)
        k4 = cuda_ms(lambda: ft.field_backward_v5(packed, mc, g, acts, d_out,
                                                  f_out, S))
        print(f"  K8 pass {p}: {n} rows, kernel {k:.4f} ms, plain {pl:.4f} "
              f"ms, bound {b:.4f} ms ({by}); K4 on K3's spill {k4:.4f} ms "
              f"(median of 10; {card})", flush=True)
        results["field_backward_v4"].update(ms=k, plain_ms=pl, bound_ms=b,
                                            bound_by=by)
    return results


def step_peak_memory(trainer, config, card, label: str) -> None:
    """The peak device memory of one full-width train step of `trainer`
    under `config`, above what is allocated before it (weights, data,
    optimizer state)."""
    import torch

    trainer.config = config
    trainer.train_step()  # allocator warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: peak {peak / 2**30:.4f} GiB, {(peak - base) / 2**30:.4f}"
          f" GiB above the {base / 2**30:.4f} GiB held before the step "
          f"({card})", flush=True)


def pose_recovery(device, compute_dtype: str = "bfloat16",
                  use_pallas_acts: bool = False, field_steps: int = 300,
                  pose_steps: int = 1200, log=print):
    """rsn's pose-recovery protocol (tests/test_camera_opt_recovery.py) on
    the port: 300 field steps on the true poses of the triple scene (4
    cameras, 32x32), the frozen field's renders at the true poses as
    ground truth, poses perturbed by ~2 degrees and 0.02, then 1200
    pose-only steps (Adam 1e-3, no gauge regularizer).  -> (mean ray
    angle to the true rays before and after, in degrees; max |t|)."""
    import numpy as np
    import torch

    from rsn_torch.configs import (DataManagerConfig, ModelConfig,
                                   PipelineConfig, TrainerConfig)
    from rsn_torch.core.rays import RayBundle
    from rsn_torch.data.cameras import generate_rays
    from rsn_torch.engine.trainer import Trainer, render_image
    from rsn_torch.models import camera_opt

    model = ModelConfig(num_coarse_samples=16, num_importance_samples=16,
                        num_reflect_coarse_samples=8,
                        num_reflect_importance_samples=8,
                        eval_num_rays_per_chunk=1024,
                        compute_dtype=compute_dtype,
                        use_pallas_acts=use_pallas_acts)
    dm = DataManagerConfig(dataparser="synthetic", data="triple:cams=4,res=32",
                           train_num_rays_per_batch=256,
                           camera_optimizer="SO3xR3",
                           camera_opt_rot_penalty=0.0,
                           camera_opt_trans_penalty=0.0)
    cfg = TrainerConfig(seed=0, pipeline=PipelineConfig(datamanager=dm,
                                                        model=model))
    cfg_field = with_route(cfg, False, use_pallas_acts)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg_field, run_dir=os.path.join(tmp, "field"),
                     device=device)
        for _ in range(field_steps):
            tr.train_step()
        trained = {k: v.clone() for k, v in tr.field.state_dict().items()}
        cams = tr.cameras
        gt = np.stack([np.clip(render_image(tr.field, cams, i, cfg_field)
                               ["mid_reflect_fine"], 0, 1)
                       for i in range(4)]).astype(np.float32)

        rng = np.random.default_rng(7)
        c2w = cams.camera_to_worlds.cpu().numpy().copy()
        for i in range(c2w.shape[0]):
            w = rng.normal(0, 0.02, 3)
            th = np.linalg.norm(w)
            K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                          [-w[1], w[0], 0]])
            rot = (np.eye(3) + np.sin(th) / th * K
                   + (1 - np.cos(th)) / th ** 2 * K @ K)
            c2w[i, :, :3] = c2w[i, :, :3] @ rot
            c2w[i, :, 3] = c2w[i, :, 3] + rng.normal(0, 0.02, 3)
        bad = dataclasses.replace(cams, camera_to_worlds=torch.as_tensor(
            c2w, dtype=torch.float32, device=device))

        tc = Trainer(cfg, run_dir=os.path.join(tmp, "pose"), device=device)
        tc.field.load_state_dict(trained)
        tc.images = torch.as_tensor(gt, device=device)
        tc.cameras = bad
        for _ in range(pose_steps):
            tc.train_step()
            tc.field.load_state_dict(trained)  # pose-only: the field frozen
        deltas = tc.camera.detach()

    yy, xx = np.meshgrid(np.arange(0, 32, 4), np.arange(0, 32, 4),
                         indexing="ij")
    py = torch.as_tensor(yy.ravel(), device=device)
    px = torch.as_tensor(xx.ravel(), device=device)

    def ang(a, b):
        cos = (a * b).sum(-1).clamp(-1.0, 1.0)
        return float(torch.rad2deg(torch.arccos(cos)).mean())

    before, after = [], []
    for c in range(4):
        ci = torch.full_like(py, c)
        _, d_true, _ = generate_rays(cams, ci, py, px)
        o_bad, d_bad, _ = generate_rays(bad, ci, py, px)
        ones = torch.ones_like(o_bad[..., :1])
        rb = RayBundle(origins=o_bad, directions=d_bad, pixel_area=ones,
                       nears=ones * 0, fars=ones, camera_indices=ci[:, None])
        fixed = camera_opt.apply_to_bundle(rb, deltas, "SO3xR3")
        before.append(ang(d_bad, d_true))
        after.append(ang(fixed.directions, d_true))
    trans = float(deltas[:, 3:].abs().max())
    log(f"  pose recovery ({compute_dtype}, use_pallas_acts "
        f"{use_pallas_acts}): mean ray error {np.mean(before):.6f} deg -> "
        f"{np.mean(after):.6f} deg (ratio {np.mean(after) / np.mean(before):.4f},"
        f" limit 0.75), max |t| {trans:.6f} (limit 0.3); "
        f"{time.perf_counter() - t0:.1f} s")
    return float(np.mean(before)), float(np.mean(after)), trans


def camera_phases(config, field, device, card):
    """Phases 12-15 -> {"kernels": K7's, K1 train width's and K8's results,
    "launches": their launches in the camera-on train CLI run, "calls":
    phase 12's captured kernel inputs}."""
    import torch

    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.engine import trainer as trainer_lib
    from rsn_torch.kernels import field_forward as ff

    phase("phase 12: K7, K1 at the train width and K8 against plain versions "
          "at the shapes of one full-width camera-on train step")
    cam_cfg = with_route(config, True, False)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_lib.Trainer(cam_cfg, run_dir=os.path.join(tmp, "r"),
                                      device=device)
        trainer.field.load_state_dict(field.state_dict())
        with torch.no_grad():
            trainer.camera.copy_(0.01 * torch.randn(
                trainer.camera.shape,
                generator=torch.Generator().manual_seed(SEED)))
        calls = capture_recompute_inputs(trainer, 50)
        results = check_recompute_kernels(calls, card)
        torch.cuda.empty_cache()
        # one trainer per camera setting; the route switches in its config
        off = trainer_lib.Trainer(with_route(config, False, True),
                                  run_dir=os.path.join(tmp, "o"),
                                  device=device)
        off.field.load_state_dict(field.state_dict())
        for tr, camera in ((off, False), (trainer, True)):
            for acts in (True, False):
                step_peak_memory(
                    tr, with_route(config, camera, acts), card,
                    f"one step, camera {'on' if camera else 'off'}, "
                    f"{'spill (K3-K5)' if acts else 'recompute (K7/K1/K8)'}")
        del trainer, off
    torch.cuda.empty_cache()

    phase("phase 13: one 64-ray camera-on train step, CPU (plain versions) "
          "against GPU (kernels), both routes")
    for acts in (True, False):
        print(f"  use_pallas_acts {acts}:")
        cpu_gpu_train_step(with_route(config, True, acts), field, device,
                           camera=True)

    phase(f"phase 14: rsn_torch.cli.train reflect-sampling-nerf "
          f"{' '.join(CAMERA_FLAGS)}, {TRAIN_STEPS} steps at full width, "
          f"then one {FRAME_RES}x{FRAME_RES} orbit frame of the run")
    with tempfile.TemporaryDirectory() as tmp:
        run, launches = run_train_cli(
            card, "reflect-sampling-nerf", CAMERA_FLAGS,
            {"field_forward_v4": 2, "field_forward_v3_train": 2,
             "field_backward_v4": 8}, tmp)
        state = ckpt_lib.load_checkpoint(os.path.join(
            run, "checkpoints", f"step-{TRAIN_STEPS:09d}.pt"))
        deltas = state["camera"]
        print(f"  pose deltas in the last checkpoint: shape "
              f"{tuple(deltas.shape)}, max |delta| "
              f"{float(deltas.abs().max()):.6g}, finite "
              f"{bool(torch.isfinite(deltas).all())}")
        if not torch.isfinite(deltas).all() or not deltas.abs().max() > 0:
            raise RuntimeError("the pose deltas did not move or are not "
                               "finite")
        frames = os.path.join(tmp, "frames")
        text, stats, render_launches = run_render_cli(run, frames,
                                                      "--num-frames", "1")
        print(text, end="")
        px = png_pixels(os.path.join(frames, "frame_00000.png"))
        if (len(stats) != 1 or px.shape != (FRAME_RES, FRAME_RES * 3)
                or px.min() == px.max()
                or any(render_launches[k] for k in RECOMPUTE_KERNELS)):
            raise RuntimeError("the camera run's orbit frame failed")

    phase("phase 15: pose recovery (rsn's protocol), bf16 on K7 / K1 / K8")
    ff.reset_launch_counts()
    before, after, trans = pose_recovery(device, "bfloat16", False)
    used = {k: ff.LAUNCHES[k] for k in RECOMPUTE_KERNELS}
    print(f"  launches: {used}")
    if not all(used.values()):
        raise RuntimeError("the recovery run did not go through K7 / K1 / K8")
    if not (after < 0.75 * before and trans < 0.3):
        print("  bf16 misses rsn's conditions; the same protocol in fp32:")
        before, after, trans = pose_recovery(device, "float32", True)
        if not (after < 0.75 * before and trans < 0.3):
            raise RuntimeError("pose recovery failed")
    return {"kernels": results, "launches": launches, "calls": calls}


# ---- the field API (K11, K12) and the schedule variants (K10, K13) ---------

API_KERNELS = ("field_forward_v2", "field_forward", "field_forward_v5",
               "field_backward_v3")


def api_phase(field, render_mc, cam_calls, card):
    """Phase 16 -> {"kernels": K10-K13's results, "launches": their
    launches in the run of this slice's path (the field's kernel route and
    the kernel API; no CLI path calls them, as in rsn)}."""
    import torch

    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft

    phase("phase 16: K10-K13 against plain versions at main-path shapes")
    fpacked, fmc, g, S, _ = cam_calls["fwd"][2]  # pass 2: with the normals
    bwd = {p: cam_calls["bwd"][p] for p in (2, 4)}
    ff.reset_launch_counts()
    route = field.get_field_outputs(render_mc[:, 0:3], render_mc[:, 3:6],
                                    use_pallas=True, differentiable=False)
    packed = ff.pack_params(field)
    enc = ff.ipe_enc(render_mc)
    k12 = ff.field_forward(packed, enc)
    k10 = {True: ft.field_forward_v5(fpacked, fmc, g, S, True),
           False: ft.field_forward_v5(fpacked[:20], fmc, g, S, False)}
    k13 = {p: ft.field_backward_v3(*args) for p, args in bwd.items()}
    torch.cuda.synchronize()
    launches = {k: ff.LAUNCHES[k] for k in API_KERNELS}
    print(f"  launches in the path's run (the kernel route, the kernel API): "
          f"{launches}; the CLI runs launch none of them (no CLI caller, as "
          f"in rsn)")
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the field API never launched")
    results = {k: {"err": 0.0} for k in API_KERNELS}
    n = render_mc.shape[0]

    # K11 and K12 on the render chunk's rows
    live = list(range(ff.N_HEAD_COLS))
    k11 = ff.field_forward_v2(packed, render_mc)
    ref = ff.field_forward_v2_plain(packed, render_mc)
    torch.cuda.synchronize()
    results["field_forward_v2"]["err"] = compare("K11 pass 2", k11, ref, live)
    del ref
    if torch.any(k11[:, ff.N_HEAD_COLS:] != 0):
        raise RuntimeError("K11's padding columns are not zero")
    if not (torch.equal(route["bottleneck"], k11[:, ff.OUT_BOTTLENECK])
            and torch.equal(route["density_preact"],
                            k11[:, ff.OUT_DENSITY:ff.OUT_DENSITY + 1].float())
            and all(torch.isfinite(v.float()).all() for v in route.values())):
        raise RuntimeError("the kernel route's outputs are not K11's")
    print(f"  Field.get_field_outputs(use_pallas=True, differentiable=False): "
          f"{len(route)} outputs of {n} rows, finite; its bottleneck and "
          f"density pre-activation == K11's, bit for bit")
    del route
    ref = ff.field_forward_plain(packed, enc)
    torch.cuda.synchronize()
    results["field_forward"]["err"] = compare(
        "K12 pass 2 (the rows' IPE encoding)", k12, ref, live)
    del ref
    e12 = float((k12.float() - k11.float()).abs().max())
    dens = ff.field_forward_density(ff.pack_params_density(field), render_mc)
    ed = float((k11[:, ff.OUT_DENSITY].float() - dens[:, 0].float()).abs()
               .max())
    print(f"  K12 on the plain encoding within {e12:.6g} of K11; K11's "
          f"density column within {ed:.6g} of K2's (polynomial IPE; limit "
          f"{ATOL})")
    if ed > ATOL:
        raise RuntimeError("K11's density disagrees with K2's")
    del k11, k12, dens

    # K10 on the camera-on step's pass 2, both flags
    k7 = ft.field_forward_v4(fpacked, fmc, g, S)
    k1 = ft.field_forward_v3_train(fpacked[:20], fmc, g, S)
    torch.cuda.synchronize()
    if not (torch.equal(k10[True], k7) and torch.equal(k10[False], k1)):
        raise RuntimeError("K10 differs from K7 or K1 at the train width")
    print(f"  K10 pass 2 ({fmc.shape[0]} rows): == K7 (normals) and == K1 at "
          f"the train width, bit for bit")
    for normals in (True, False):
        ref = ft.field_forward_v4_plain(fpacked if normals else fpacked[:20],
                                        fmc, g, S, normals)
        err = compare(f"K10 pass 2 (normals={normals})", k10[normals], ref,
                      list(range(14)) + list(range(17, 20)))
        results["field_forward_v5"]["err"] = max(
            results["field_forward_v5"]["err"], err)

    # K13 on K8's captured inputs of passes 2 and 4
    r13 = results["field_backward_v3"]
    for p, args in bwd.items():
        again = ft.field_backward_v3(*args)
        k8 = ft.field_backward_v4(*args)
        torch.cuda.synchronize()
        if not same_grads(k13[p], again):
            raise RuntimeError(f"K13 pass {p} differs from itself")
        if not (torch.equal(k13[p][0], k8[0])
                and torch.equal(k13[p][1], k8[1])):
            raise RuntimeError(f"K13 pass {p}: dmc or dg differ from K8's")
        werr = max(rel_err(a, b) for a, b in zip(k13[p][2], k8[2]))
        plain = ft.field_backward_v4_plain(*args)
        errs = {"dmc": rel_err(k13[p][0], plain[0]),
                "dg": rel_err(k13[p][1], plain[1]),
                "dpacked": max(rel_err(a, b)
                               for a, b in zip(k13[p][2], plain[2]))}
        print(f"  K13 pass {p}: rows {args[1].shape[0]}, == itself, dmc and "
              f"dg == K8's, bit for bit; weight gradients within {werr:.6g} "
              f"of K8's (limit {K13_TOL}); against its plain version: "
              + ", ".join(f"{k} {v:.6g}" for k, v in errs.items())
              + f" (limit {K8_TOL})", flush=True)
        if werr > K13_TOL or max(errs.values()) > K8_TOL:
            raise RuntimeError(f"K13 pass {p} disagrees")
        r13["err"] = max(r13["err"], max(errs.values()))

    # times and bounds
    w2 = nbytes(*packed)
    for name, tag, fn, plain_fn, x in (
            ("field_forward_v2", "K11", ff.field_forward_v2,
             ff.field_forward_v2_plain, render_mc),
            ("field_forward", "K12", ff.field_forward, ff.field_forward_plain,
             enc)):
        k = cuda_ms(lambda: fn(packed, x))
        pl = cuda_ms(lambda: plain_fn(packed, x))
        b, by = bound(FLOPS[name] * n, nbytes(x) + w2 + n * ff.OUT_DIM * 2)
        print(f"  {tag} pass 2: {n} rows, kernel {k:.4f} ms, plain {pl:.4f} "
              f"ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        results[name].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    del enc
    nf = fmc.shape[0]
    w_bytes = nbytes(*fpacked[:20])
    for normals in (True, False):
        pk = fpacked if normals else fpacked[:20]
        ms = {"K10": cuda_ms(lambda: ft.field_forward_v5(pk, fmc, g, S,
                                                         normals))}
        other = "K7" if normals else "K1 train width"
        ms[other] = cuda_ms(lambda: (ft.field_forward_v4 if normals else
                                     ft.field_forward_v3_train)(pk, fmc, g, S))
        pl = cuda_ms(lambda: ft.field_forward_v4_plain(pk, fmc, g, S,
                                                       normals))
        flops = (FLOPS["field_forward_v6"] + (2 * DGRAD_MACS if normals
                                              else 0)) * nf
        b, by = bound(flops, nbytes(fmc, g, *pk[20:]) + w_bytes
                      + nf * ft.OUT_TRAIN * 2)
        print(f"  K10 pass 2 (normals={normals}): {nf} rows, kernel "
              f"{ms['K10']:.4f} ms, {other} {ms[other]:.4f} ms, plain "
              f"{pl:.4f} ms, bound {b:.4f} ms ({by}; median of 10; {card})",
              flush=True)
        if normals:
            results["field_forward_v5"].update(ms=ms["K10"], plain_ms=pl,
                                               bound_ms=b, bound_by=by)
    for p in (4, 2):
        args = bwd[p]
        _, mc, g8, d_out, f_out, _ = args
        k = cuda_ms(lambda: ft.field_backward_v3(*args))
        k8 = cuda_ms(lambda: ft.field_backward_v4(*args))
        pl = cuda_ms(lambda: ft.field_backward_v4_plain(*args))
        outs = g8.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + mc.shape[0] * 16 * 4
        b, by = bound(FLOPS["field_backward_v4"] * mc.shape[0],
                      nbytes(mc, g8, d_out, f_out) + w_bytes + outs)
        print(f"  K13 pass {p}: {mc.shape[0]} rows, kernel {k:.4f} ms, K8 "
              f"{k8:.4f} ms, plain {pl:.4f} ms, bound {b:.4f} ms ({by}; "
              f"median of 10; {card})", flush=True)
        r13.update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    return {"kernels": results, "launches": launches}


if __name__ == "__main__":
    sys.exit(main())
