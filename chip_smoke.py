#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsn_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. device   — the card, torch / CUDA versions, nvidia-smi name and
                power limit; TF32 off for fp32 matmuls and convolutions.
  2. build    — compiles rsn_torch/csrc/*.cu for sm_90a into
                rsn_torch/_build/, one nvcc per source, all at once (the
                first call of a checkout builds), and beside them
                field_train.cu with RSN_ABLATE_NO_SPILL (K3 without its
                spill stores) for phase 6's timing, proposal_forward.cu
                with RSN_K9_FIRST_DESIGN (K9's first design) for phase 9,
                experiments.cu with RSN_K14_FIRST_DESIGN (K14's and K15's
                first design) for phases 3 and 17, and field_forward.cu
                with RSN_K11_FIRST_DESIGN (K11's and K12's first design)
                for phase 16, experiments_bwd.cu with RSN_K18_FIRST_DESIGN
                (the first design of K18's four modes and of K19) for
                phase 18,
                field_train.cu with RSN_K13_FIRST_DESIGN and
                RSN_K10_FIRST_DESIGN (K13's, K17's and K10's first
                designs, one nvcc) for phases 12, 16 and 18;
                the registers and spills of K14 / K15's four kernels and of
                K11's and K12's (none may spill), of K18 / K19's kernel A
                (read) and their kernel B (which may not spill), of K18's
                ring recompute, kernel F and body on its spill (read), of K8 /
                K13's kernel A, K17's, K13's sum and their kernel B (read),
                of K10 beside K7 and K1 at the train width, with the
                local-memory loads and stores (LDL / STL) in each one's
                SASS (read).
  3. kernels  — K1 (field_forward_v3) and K2 (field_forward_density)
                against their plain PyTorch versions on the card, on the
                real inputs of one 16384-ray chunk of the first 800x800
                orbit frame (passes 1-4), plus K2's density column
                against K1's, bit for bit, and CUDA-event times beside K14
                v3u's first design (the 64-row wmma design that K1 and K2
                replaced) in the same call; the
                wgmma / mma.sync probe (one 64 x 256 x 256 bf16 layer by
                both instructions, fp32 sums bit for bit); K1's and K2's
                registers and spills from the build.
  4. cpu/gpu  — one 32x32 frame rendered on the CPU (plain versions) and
                on the card (kernels), product_only both ways.
  5. render   — `python -m rsn_torch.cli.render --mode orbit` on a run
                dir with seed-drawn weights (the registry's
                reflect-sampling-nerf config, compute_dtype bfloat16,
                synthetic sphere at 800x800); the kernels' launch counts
                of that run, then a 400x400 full (not product-only) render.
  6. train kernels — the step's weight blob (one pack launch) against
                its plain version, K3 (field_forward_v6), K5
                (field_backward_v6) and K4 (field_backward_v5) against
                their plain versions on the real inputs of one
                full-width train step (1024 rays, step 50: the normal
                losses on), K3 == K7 / K1 at the train width and K3's
                density column == K1's, K5 == K4 on the same spill (dg,
                all 20 gradients) bit for bit, CUDA-event times (K3's
                spill alone: K3 beside the RSN_ABLATE_NO_SPILL build, in
                turns; K5 at pass 2 and K4 at pass 4 with their kernels A
                and B apart), each call's scratch.
  7. cpu/gpu step — one 64-ray train step with midpoint draws on the CPU
                (plain versions) and on the card (kernels): losses and
                every parameter gradient.
  8. train    — `python -m rsn_torch.cli.train reflect-sampling-nerf` for
                60 steps at full width on the synthetic sphere at 800x800,
                with the eval hooks every 20 (batch) and 60 (image) steps:
                launches per step (K4's and K5's kernels A once per chunk
                of each call, kernel B once per chunk of both), finite
                and falling losses, the eval
                lines and the three panel PNGs (fine SSIM in [0, 1]), the
                checkpoint; then one orbit frame of the trained run at
                downscale 4 through the render CLI.
  The proposal preset (reflect-sampling-nerf-proposal, bf16, with
  use_pallas_proposal set by its config flag):
  9. K9       — K9 (prop_forward) against its plain version on the card,
                on the real pass-1 and pass-3 inputs of the middle chunk of
                the first 800x800 preset orbit frame, and against its first
                design (the RSN_K9_FIRST_DESIGN build) bit for bit;
                CUDA-event times, the first design's in turns with K9's
                (back to back);
                the FP32, MUFU and other instructions per row of the tile
                loop of K9's SASS (cuobjdump) and the floors they set (a
                reading only: a SASS it cannot parse is printed, not
                failed).
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
                outputs against K3's bit for bit; K8 the same twice and
                equal to K4 on K3's spill (dmc, dg, all 20 gradients) bit
                for bit, its weight matrices within K13_TOL of K13's first
                design's (the RSN_K13_FIRST_DESIGN build: per-block
                slices); kernel B alone against
                its plain contraction on the records kernel A leaves of
                pass 2, and cuBLAS on the same operands (four calls);
                CUDA-event times (K7, K1 at the train width; K8, its
                kernels A and B alone, K13's first design in the
                same call), K8's scratch per call
                beside the first design's; the peak device memory of one
                full-width step on each route, camera off and on.
  13. cpu/gpu camera step — one 64-ray camera-on step on the CPU (plain
                versions) and on the card (kernels), on both routes:
                losses, field gradients and pose-delta gradients.
  14. camera train — `python -m rsn_torch.cli.train reflect-sampling-nerf
                --pipeline.datamanager.camera-optimizer SO3xR3
                --pipeline.model.use-pallas-acts False` for 60 full-width
                steps (launches per step: K8's kernels A and B once per
                chunk; falling losses, moving deltas in the checkpoint),
                then one 800x800 orbit frame of the run.
  15. pose recovery — rsn's protocol (tests/test_camera_opt_recovery.py)
                in bf16 on K7 / K1 / K8: the deltas must pull perturbed
                rays back toward the true ones.
  The field API and the schedule variants:
  16. K10-K13 — the slice's path from zeroed launch counts: K11
                (field_forward_v2) through Field.get_field_outputs(
                use_pallas=True, differentiable=False) on phase 3's pass-2
                render chunk (2,097,152 rows), K12 (field_forward) on the
                IPE encoding of the same rows, K10 (field_forward_v5) with
                both flags on phase 12's train blob and K13
                (field_backward_v3) on phase 12's
                camera-on inputs (passes 2 and 4); each against its plain
                version; K11 and K12 == their first design (the
                RSN_K11_FIRST_DESIGN build) bit for bit on the 2,097,152
                rows, their padding columns zero; K10 == K7 and K1 at the
                train width, == its first design (the RSN_K10_FIRST_DESIGN
                build: the 64-row wmma forward) and K7 / K1 == that first
                design, bit for bit; K13 (K8's kernel A and kernel B once per
                chunk, then its sum, each launch counted) == its first
                design (the RSN_K13_FIRST_DESIGN build) and == K8 on dmc
                and dg, bit for bit, its 20 gradients within 1e-4 of both
                (the ulps from K8's printed), the same twice, its sum ==
                its plain version bit for bit;
                CUDA-event times, K11 and K12 one call per event pair and
                back to back in turns with their first design, K10 with
                both flags one call beside its first design, K7 / K1 and
                the plain version, then back to back in turns with its
                first design and with K7 / K1, K13 one call
                beside its first design's and K8's, then back to back in
                turns with its first design, kernel A, kernel B and the
                sum apart, each design's scratch; kernel B alone on K13's
                pass-4 chunk beside cuBLAS.
  The tools' forward experiments:
  17. K14-K16 — from zeroed launch counts, K14 (field_forward_v3u,
                field_forward_v3i) and K15 (field_forward_v3L, and with
                full field_forward_v3F) on phase 3's pass-2 render chunk
                (2,097,152 rows), each against its plain version and its
                first design (the RSN_K14_FIRST_DESIGN build) bit for bit,
                v3i == v3u and v3F == v3L bit for bit, v3u and v3L on
                columns 0:14 against K1 on the same rows; CUDA-event times,
                one call per event pair, then each variant back to back in
                turns with its first design and K1; K16 (cheap_sin) in its
                eight modes on (2,097,152, 128) f32 rows of the tool's
                distribution, each against its plain version; CUDA-event
                times beside K1's; K16's and one PyTorch call's each
                (most on an argument computed beforehand), one call per
                event pair as every row's, then in turns back to back so
                that host time hides under device time.
  The tools' backward experiments:
  18. K17-K19 — from zeroed launch counts, on the tools' rows (131,072
                rows, 128 samples per ray, the field from seed 0, a seeded
                (N, 128) cotangent): K17 (field_backward_whole: its
                128-row kernel A and kernel B once per chunk), K18
                (bwd_ablate.run) in its four modes and K19 (run_noipe) on
                K3's spill of the same rows; each against its plain
                version fed the kernel's activations (ATOL of each
                output's max; K18 and K19 with K12's bottleneck, their dg
                on the rays whose mid_pre cannot change sign with the
                order of the fp32 sums) and, K17 and K18, against the
                plain version that recomputes its trunk (K8_TOL); K19 ==
                K18's full mode
                on dg and the 22 weight gradients, bit for bit; K18 full +
                wgrad and K19 run kernel A and kernel B once per chunk
                (their launches counted), dmc and dg == their first design
                (the RSN_K18_FIRST_DESIGN build) bit for bit, the 22
                gradients within K13_TOL of it; K18's modes without weight
                gradients on the ring (recompute one launch of the unfolded
                ring forward; full and no_ipe_bwd kernel F, the ring's
                trunk writing K3's spill layout, then the body on that
                spill; launches counted): dmc and dg == their first design
                bit for bit, kernel F's spill == K3's bit for bit; K17
                against K8 on the tools' rows and on phase 12's pass-2 and
                pass-4 rows: dmc and w0..w7, w_hc bit for bit, dg and the
                other 11 gradients within K13_TOL, and against its first
                design (RSN_K13_FIRST_DESIGN): dmc bit for bit, dg and the
                20 gradients within K13_TOL; CUDA-event times beside K8's
                and K4's; K17, K18
                full + wgrad and K19 one call each beside their first
                design's, then back to back in turns with it, kernel A
                and kernel B apart, each call's scratch; K18's three
                modes without weight gradients likewise beside their first
                design, kernel F and the body apart, each call's scratch;
                kernel B alone on
                the last chunk (K17's and K18's) against its plain
                contraction and cuBLAS / one torch.bmm / torch.mm set on
                the unstashed operands.
  The user path around a trained scene:
  19. user path — write_blender_scene writes the sphere as a Blender-format
                scene at 800x800 (4 cameras a split) and the native PNG
                decoder reads it (== the zlib decoder's pixels; ms per
                PNG beside the zlib decoder's, host CPU); `python -m
                rsn_torch.cli.train reflect-sampling-nerf` on it
                (dataparser blender, bf16, USER_STEPS full-width steps;
                its log lines printed, K3-K5 launched, losses finite);
                `python -m rsn_torch.cli.eval --max-images 2` with
                RSN_LPIPS_WEIGHTS set to a seeded LPIPS file that
                export_torch_state_dict writes: eval.json's five keys
                finite, K1 launched, image 0's card LPIPS within LPIPS_TOL
                of the CPU LPIPS of the same two images, s per image and
                LPIPS ms at 800x800; a bare `python -m
                rsn_torch.cli.render --load-dir RUN --max-images 1` (split
                mode: the three panels, K1 on all four passes); `--mode
                interpolate --num-frames 4 --video --downscale-factor 4`
                (K2 and K1 launched; a GIF the port's reader decodes to 4
                frames within half a palette level of the PNG frames, or
                an mp4 where ffmpeg is on the path); `python -m
                rsn_torch.cli.convert` export -> import -> export: the two
                .ckpt state dicts equal bit for bit, and equal to the
                trained field.
  20. export and viewer — on phase 19's trained run: one grid plane of
                the density (256 x 256 points, fp32) on the card against
                the CPU (QUERY_TOL); `python -m rsn_torch.cli.export mesh
                --resolution 256` with the iso at a high quantile of the
                density at random points (vertices and faces, unit
                normals, colors in [0, 1]; the grid's seconds on the
                card, the isosurface's on the host, the colors' and
                normals' on the card); `export pointcloud --max-images 2`
                and `export tsdf --max-images 2 --resolution 128` (K1 on
                all four passes of every chunk of both images, K2 none;
                s per image), `export cameras`, each read back through
                read_ply or json; the viewer in process (`load_state`,
                the warm-up's ms per quality level, a ThreadingHTTPServer
                on 127.0.0.1 and a websocket client): one pose, three
                binary frames with quality bytes 0, 1, 2 at 100, 200 and
                400 pixels square (ms per level at the client), K2 and K1
                launched; the q=2 frame and GET /render == the product
                render at that pose, bit for bit; POST /export_path with
                two poses, then `python -m rsn_torch.cli.render --mode
                path` renders the file.
  21. JPEG frames — the committed fixtures of tests/golden/jpeg/ decoded
                by the port's JPEG decoder to the mode, shape and sha256
                of PIL's decode recorded in digests.json (ms per 800x800
                frame beside the native PNG decoder's on phase 19's PNGs,
                host CPU, one thread); the fixtures of
                tests/golden/jpeg_kinds/ (Motion-JPEG, every sampling
                layout, CMYK / YCCK, arithmetic, lossless, smoothed
                progressive) to their digests the same way, then one
                800x800 frame of each kind written by that folder's numpy
                writer and decoded (ms per frame, host CPU, one thread,
                best of 3, beside the baseline frame's; the lossless frame
                equal to the writer's pixels, the CMYK one their inverse
                within 3 on average); a nerfstudio-format capture over
                the five 800x800 JPEG frames with the synthetic cameras'
                poses and intrinsics; `python -m rsn_torch.cli.train
                reflect-sampling-nerf` on it three times (dataparser
                nerfstudio, bf16, JPEG_STEPS full-width steps, --vis
                tensorboard; the second with --profile-dir over
                JPEG_PROFILE): finite log lines, K3-K5 launched, no tb
                writer where tensorboardX is missing, one Chrome trace
                holding JPEG_PROFILE's steps (a RAdam annotation for an
                eager step, a Trainer.train_step#graph_replay one for a
                replay) and CUDA kernel events of the hand-written
                kernels; each run's host ms per step
                and the host's us per launch before the runs and after
                each (whether the window's cost outlasts it); `python -m
                rsn_torch.cli.eval --max-images 1`: eval.json's five keys
                finite, K1 launched.
  Several ranks (rsn_torch.parallel.mesh, one rank per device):
  22. multi-device — at full width (the default method, bf16, 1024 rays a
                rank, the sphere at 800x800, seed 3):
                a. torch.distributed.is_nccl_available() (False fails);
                `python -m rsn_torch.cli.train reflect-sampling-nerf
                --multihost --coordinator-address 127.0.0.1:<port>
                --num-processes 1 --process-id 0` (a one-rank NCCL group)
                and the plain CLI, MESH_STEPS steps each at once: every
                tensor of the final checkpoints equal bit for bit; then a
                one-rank NCCL Trainer in this process: the gradients'
                all-reduce (average_gradients) and one dist.all_reduce of
                the same flat buffer in ms per step, CUDA events, beside
                the step's ms.
                b. two ranks on the one card (NCCL refuses two ranks on a
                device, so gloo, CUDA tensors staged through the host):
                one train step each from seed 3's weights, every rank's
                kernel launches printed; their replicas equal bit for
                bit, and within MESH_TOL of one process that computes
                both ranks' gradients with their generators, averages
                them and steps RAdam.
                c. the same two ranks render orbit frame 0 at 800x800
                sharded (product only: K2 on passes 1 and 3, K1 on 2 and
                4; a warm-up render first), each rank's seconds and
                launches; the whole frame on each rank == this process's
                single-rank render, bit for bit.
  23. graphed dispatch — the train loop's chunks on the card are replays
                of a CUDA graph of one whole step (rsn_torch.engine.trainer):
                on the default method, the preset (K9 on in the eval
                batches) and the camera-on recompute route, each at full
                width on the sphere at 800x800 from seed 3, train() over
                DISPATCH_STEPS steps (log and controller every 10, an
                eval batch every 20, past the warmup's step 50) against
                as many eager train_step calls with the loop's controller
                and eval batches: every parameter, the optimizers' state,
                the generators' states, the logged losses and eval
                batches bit for bit, the launches equal; each capture's
                seconds and replays, the peak memory allocated each way,
                ms per step graphed against eager in turns (host clock
                and CUDA events), the launches per step the replays
                report, the device's idle share each way over a
                torch.profiler window.  On the default method: a bucket
                forced at step 30 (a second capture) against the eager
                steps, bit for bit; a save at step 30 restored into a new
                Trainer and graphed to step 60 == the uninterrupted run,
                every tensor bit for bit.
  24. TIFF frames — the committed fixtures of tests/golden/tiff/ decoded
                through read_image to the mode, shape, dtype and sha256 of
                PIL's decode recorded in digests.json; one 800x800 RGB
                frame of each of that writer's TIMED_KINDS (no
                compression, PackBits, LZW and Deflate with and without
                predictor 2, JPEG YCbCr 4:2:0, 16-bit, planar, tiled)
                decoded (the writer's samples back, JPEG within 3 on
                average of its YCbCr's RGB), ms per frame (host CPU, one
                thread, best of 3, warm) beside the native PNG decoder and
                the baseline JPEG decoder on the same frame; phase 21's
                five JPEG frames written as TIFFs (LZW, predictor 2,
                8-bit RGB) under a nerfstudio capture, load_dataset ==
                their pixels / 255; `python -m rsn_torch.cli.train` on it
                (JPEG_STEPS bf16 steps, --vis tensorboard): finite log
                lines, K3-K5 launched; `python -m rsn_torch.cli.eval
                --max-images 1`: eval.json's five keys finite, K1
                launched.
  25. WebP frames — the committed fixtures of tests/golden/webp/ decoded
                through read_image to PIL's recorded digest (the writer's
                VP8L / VP8 / ALPH cases, PIL's encoder's files, the five
                frames); the writer's 800x800 VP8L frame == its samples;
                ms per 800x800 frame (host CPU, one thread, best of 3,
                warm) of the committed lossy frame, the writer's lossless
                frame and the lossy frame with the writer's ALPH chunk,
                beside the native PNG decoder and the baseline JPEG
                decoder on the same pixels; the five lossy frames (phase
                21's JPEG frames' pixels at quality 90) under a nerfstudio
                capture, load_dataset == their pixels / 255; `python -m
                rsn_torch.cli.train` on it (JPEG_STEPS bf16 steps, graphed,
                --vis tensorboard): finite log lines, K3-K5 launched.
  26. BMP, PPM, GIF and TGA frames — the committed fixtures of
                tests/golden/{bmp,ppm,gif,tga}/ decoded through read_image
                to PIL's recorded digest, and PIL's refusals refused
                (ValueError); phase 21's first JPEG frame's pixels written
                by those folders' numpy writers as an 800x800 BMP (24-bit
                and RLE8 of its green band), PPM P6, 16-bit PGM, GIF (its
                green band, mode L) and RLE TGA, each decoded back to its
                pixels, ms per frame (host CPU, one thread, best of 3,
                warm) beside the native PNG decoder and the baseline JPEG
                decoder on the same pixels; phase 21's five frames as a
                nerfstudio capture of a BMP, a PPM, a TGA, a GIF and an
                RLE8 BMP, load_dataset == their pixels / 255; `python -m
                rsn_torch.cli.train` on it (JPEG_STEPS bf16 steps,
                graphed, --vis tensorboard): finite log lines, K3-K5 and
                the blob launched, host ms per step.
  27. JPEG 2000 frames — the committed fixtures of tests/golden/jpeg2000/
                (PIL's writer, OpenJPEG's encoder, struct rewraps) decoded
                through read_image to PIL's recorded digest, and PIL's
                refusals refused (ValueError); its five 800x800 frames
                (RGB 5/3, RGB 9/7 at rate 20, RGB 9/7 in three layers,
                RPCL, 256 tiles, L 5/3, I;16 5/3), ms per frame (host
                CPU, one thread, best of 3, warm) beside the native PNG
                decoder and the baseline JPEG decoder on the same pixels
                (8-bit: the I;16 frame's high byte); the five as a
                nerfstudio capture, load_dataset == their pixels / 255;
                `python -m rsn_torch.cli.train` on it (JPEG_STEPS bf16
                steps, graphed, --vis tensorboard): finite log lines,
                K3-K5 and the blob launched, host ms per step.
  28. AVIF frames — the committed fixtures of tests/golden/avif/ (PIL's
                writer, struct rewraps, AV1 streams written by hand)
                decoded through read_image to PIL's recorded digest, the
                kinds not ported refused (NotImplementedError) and PIL's
                refusals refused; its five 800x800 frames (the defaults,
                speed 0 with loop restoration, quality 100 4:4:4, RGBA
                with a disc of alpha, 4:0:0), ms per frame (host CPU, one
                thread, best of 3, warm) beside the native PNG decoder and
                the baseline JPEG decoder on the same pixels; the five as
                a nerfstudio capture, load_dataset == their pixels / 255
                (RGBA blended to white); `python -m rsn_torch.cli.train`
                on it (JPEG_STEPS bf16 steps, graphed, --vis
                tensorboard): finite log lines, K3-K5 and the blob
                launched, host ms per step.
  29. result  — the kernels' JSON line, then {"ok": true, "device": ...}.

Any failed check raises: the script then exits non-zero and prints no
result.  It imports neither jax nor PIL, nor anything of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
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
USER_STEPS = 10     # phase 19's train run on the Blender-format scene
USER_CAMS = 4       # cameras per split of that scene
LPIPS_TOL = 1e-4    # LPIPS on the card against the CPU (fp32, TF32 off)
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
MESH_STEPS = 10     # phase 22's CLI runs, plain and one NCCL rank
MESH_TOL = 1e-5     # two ranks' step against one process averaging both

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
    from rsn_torch.utils.timing import time_kernel

    return time_kernel(fn, reps=reps, warmup=1)


def back_to_back_ms(fn, calls: int = 5) -> float:
    """Device ms of one call of `fn` when `calls` run back to back between
    two events (median of 10): each call's host time overlaps the device
    work of the one before, so a kernel and a PyTorch call compare on the
    device alone."""
    def run():
        for _ in range(calls):
            fn()
    return cuda_ms(run) / calls


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
    from rsn_torch.kernels.build import (build_library, finish_variants,
                                         load_library, start_variant)

    t0 = time.perf_counter()
    # beside the port's build: K3 without its spill stores (phase 6), K9's
    # first design (phase 9), K14's and K15's (phases 3 and 17), K11's and
    # K12's (phase 16), K18 full + wgrad's and K19's (phase 18), K13's,
    # K17's and K10's (phases 12, 16 and 18)
    waiting = {"no_spill": start_variant("field_train.cu",
                                         ("RSN_ABLATE_NO_SPILL",),
                                         "no_spill"),
               "k9_first": start_variant("proposal_forward.cu",
                                         ("RSN_K9_FIRST_DESIGN",),
                                         "first_design"),
               "k14_first": start_variant("experiments.cu",
                                          ("RSN_K14_FIRST_DESIGN",),
                                          "first_design"),
               "k11_first": start_variant("field_forward.cu",
                                          ("RSN_K11_FIRST_DESIGN",),
                                          "first_design"),
               "k18_first": start_variant("experiments_bwd.cu",
                                          ("RSN_K18_FIRST_DESIGN",),
                                          "first_design"),
               "k13_first": start_variant("field_train.cu",
                                          ("RSN_K13_FIRST_DESIGN",
                                           "RSN_K10_FIRST_DESIGN"),
                                          "first_design")}
    try:
        paths, log = build_library()
        for source in paths:
            load_library(source)
    finally:
        variants, texts = finish_variants(waiting)  # waits for every nvcc
    log += "".join(f"\n--- {name}\n{text}" for name, text in texts.items())
    print(f"built {', '.join(os.path.relpath(p, REPO) for p in paths.values())}"
          f", field_train.cu with RSN_ABLATE_NO_SPILL, "
          f"proposal_forward.cu with RSN_K9_FIRST_DESIGN, experiments.cu "
          f"with RSN_K14_FIRST_DESIGN, field_forward.cu with "
          f"RSN_K11_FIRST_DESIGN, experiments_bwd.cu with "
          f"RSN_K18_FIRST_DESIGN and field_train.cu with "
          f"RSN_K13_FIRST_DESIGN and RSN_K10_FIRST_DESIGN in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per build, in "
          f"parallel)")
    for line in log.splitlines():
        if re.search(r"^---|registers|spill", line):
            print(f"  ptxas: {line.strip()}")
    sys.stdout.flush()
    # K14 / K15's four schedules of unfolded_sm90.cuh: no spill
    kernel_registers("experiments.cu", {
        f"unfolded_kernelILi{i}E": f"K14 / K15 {v} (unfolded_kernel<{i}>)"
        for i, v in enumerate(("v3u", "v3i", "v3L", "v3F"))}, no_spill=True)
    # K11 / K12 (heads_sm90.cuh): no spill
    kernel_registers("field_forward.cu", {
        "heads_kernelILb1E": "K11 (heads_kernel<true>)",
        "heads_kernelILb0E": "K12 (heads_kernel<false>)"}, no_spill=True)
    # K18 full + wgrad's and K19's kernel A (read), their kernel B (no
    # spill)
    kernel_registers("experiments_bwd.cu", {
        "unfolded_backward_kernelILi0ELb1E":
            "K18 full + wgrad kernel A (unfolded_backward_kernel<0, true>)",
        "unfolded_backward_kernelILi4ELb1E":
            "K19 kernel A (unfolded_backward_kernel<4, true>)"})
    kernel_registers("experiments_bwd.cu", {
        "wgrad_kernelINS0_8UnfoldedE": "their kernel B "
                                       "(wgrad_kernel<Unfolded>)"},
        no_spill=True)
    # K18's modes without weight gradients on the ring: recompute, kernel
    # F, the body on kernel F's spill (read)
    kernel_registers("experiments_bwd.cu", {
        "recompute_kernel": "K18 recompute (recompute_kernel: "
                            "unfolded_body<IN_STEP, false, true>)",
        "spill_kernel": "K18 kernel F (spill_kernel)",
        "unfolded_backward_kernelILi1ELb0ELb1E":
            "K18 full body (unfolded_backward_kernel<1, false, true>)",
        "unfolded_backward_kernelILi2ELb0ELb1E":
            "K18 no_ipe_bwd body (unfolded_backward_kernel<2, false, "
            "true>)"})
    # K13's kernel A (K8's) and sum, K17's kernel A, their kernel B (read)
    kernel_registers("field_train.cu", {
        "field_backward_v4_kernel": "K8 / K13 kernel A "
                                    "(field_backward_v4_kernel)",
        "field_backward_whole_kernel": "K17 kernel A "
                                       "(field_backward_whole_kernel)",
        "field_backward_v3_sum_kernel": "K13 sum "
                                        "(field_backward_v3_sum_kernel)",
        "wgrad_kernelINS0_6FoldedE": "their kernel B "
                                     "(wgrad_kernel<Folded>)"})
    # K10 beside K7 and K1 at the train width (read): its IPE warps run at
    # the producer warpgroup's 40 registers, its consumers at 232
    k10_kernels = {
        "field_forward_v5_kernelILb1E": "K10 normals "
                                        "(field_forward_v5_kernel<true>)",
        "field_forward_v5_kernelILb0E": "K10 (field_forward_v5_kernel<false>)",
        "field_train_kernelILb1ELb0ELb0E": "K7 (field_train_kernel<true, "
                                           "false, false>)",
        "field_train_kernelILb0ELb0ELb0E": "K1 train width "
                                           "(field_train_kernel<false, false, "
                                           "false>)"}
    kernel_registers("field_train.cu", k10_kernels)
    local_memory_ops("field_train.cu", k10_kernels)

    from rsn_torch.cli import render as render_cli
    from rsn_torch.data.cameras import rescale_cameras
    from rsn_torch.data.blender import load_cameras
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
    # pass 2's rows, for phases 16 and 17
    _, render_mc, render_g, render_s = calls["v3"][0]
    # the old design's yardstick in the same call: K14 v3u's first design
    # (trunk() on 64-row tiles, wmma) on pass 2's rows
    from rsn_torch.experiments import interleave

    p3u = ff.pack_params_v3(field)
    v3u = cuda_ms(lambda: interleave.launch_kernel(
        variants["k14_first"], "rsn_field_forward_v3u", p3u, render_mc,
        render_g, render_s))
    print(f"  K1 {results['field_forward_v3']['ms']:.4f} ms and K2 "
          f"{results['field_forward_density']['ms']:.4f} ms beside K14 v3u's "
          f"first design {v3u:.4f} ms on pass 2's rows (the same call; "
          f"median of 10; {card})", flush=True)
    mma_probe(card)
    kernel_registers("field_forward.cu", {
        "field_render_kernelILb1E": "K1 (field_render_kernel<true>)",
        "field_render_kernelILb0E": "K2 (field_render_kernel<false>)"})
    del p3u, calls
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
    train_results = train_phases(config, field, device, card,
                                 variants["no_spill"])
    results.update(train_results["kernels"])
    launches.update(train_results["launches"])

    # ---- 9-11. the proposal preset ----
    preset_results = preset_phases(field, field_cpu, orbit, device, card,
                                   variants["k9_first"])
    results.update(preset_results["kernels"])
    launches.update(preset_results["launches"])

    # ---- 12-15. pose refinement and the recompute route ----
    camera_results = camera_phases(config, field, device, card,
                                   variants["k13_first"])
    results.update(camera_results["kernels"])
    # kernel B runs on both routes: its launches in phases 8 and 14
    wgrad = launches["field_backward_v4_wgrad"]
    launches.update(camera_results["launches"])
    launches["field_backward_v4_wgrad"] += wgrad

    # ---- 16. the field API and the schedule variants ----
    api_results = api_phase(field, render_mc, camera_results["calls"], card,
                            variants["k11_first"], variants["k13_first"])
    results.update(api_results["kernels"])
    launches.update(api_results["launches"])

    # ---- 17. the tools' forward experiments ----
    exp_results = experiments_phase(field, render_mc, render_g, render_s,
                                    card, variants["k14_first"])
    results.update(exp_results["kernels"])
    launches.update(exp_results["launches"])

    # ---- 18. the tools' backward experiments ----
    bwd_results = backward_experiments_phase(camera_results["calls"], card,
                                             variants["k18_first"],
                                             variants["k13_first"])
    results.update(bwd_results["kernels"])
    launches.update(bwd_results["launches"])

    # ---- 19. the user path around a trained scene ----
    # ---- 20. export and the viewer on phase 19's trained run ----
    # ---- 21. JPEG frames: the decoder and a capture of JPEGs ----
    with tempfile.TemporaryDirectory() as user_tmp:
        run = user_path_phase(card, user_tmp)
        export_viewer_phase(run, card)
        jpeg_phase(card, user_tmp, os.path.join(user_tmp, "scene"))

    # ---- 22. several ranks ----
    with tempfile.TemporaryDirectory() as mesh_tmp:
        multi_device_phase(card, mesh_tmp)

    # ---- 23. the train loop's chunks as CUDA graph replays ----
    with tempfile.TemporaryDirectory() as dispatch_tmp:
        graphed_dispatch_phase(card, dispatch_tmp)

    # ---- 24. TIFF frames: the decoder and a capture of TIFFs ----
    with tempfile.TemporaryDirectory() as tiff_tmp:
        tiff_phase(card, tiff_tmp)

    # ---- 25. WebP frames: the decoder and a capture of WebPs ----
    with tempfile.TemporaryDirectory() as webp_tmp:
        webp_phase(card, webp_tmp)

    # ---- 26. BMP, PPM, GIF and TGA frames ----
    with tempfile.TemporaryDirectory() as raster_tmp:
        raster_phase(card, raster_tmp)

    # ---- 27. JPEG 2000 frames ----
    with tempfile.TemporaryDirectory() as j2k_tmp:
        jpeg2000_phase(card, j2k_tmp)

    # ---- 28. AVIF frames ----
    with tempfile.TemporaryDirectory() as avif_tmp:
        avif_phase(card, avif_tmp)

    # ---- 29. result ----
    phase("phase 29: result")
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
            # one PyTorch call computes K16's modes, kernel B's
            # contraction and K13's sum; none a fused field or its
            # backward
            "library_ms": r.get("library_ms")})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_device_phase(card, tmp: str) -> None:
    """Phase 22: a one-rank NCCL group through the train CLI against the
    plain CLI, the all-reduce's ms per step, then two gloo ranks on the
    card: one step against one process averaging, and the sharded
    render against the single-rank one."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rsn_torch.cli import render as render_cli
    from rsn_torch.data.blender import load_cameras
    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.engine.trainer import Trainer, rank_seed, render_image
    from rsn_torch.models.field import Field
    from rsn_torch.parallel import mesh as mesh_lib

    phase(f"phase 22: multi-device: a one-rank NCCL group, two ranks on "
          f"the card ({FRAME_RES}x{FRAME_RES}, full width)")
    start = time.perf_counter()
    nccl = dist.is_nccl_available()
    print(f"  torch.distributed.is_nccl_available(): {nccl}", flush=True)
    if not nccl:
        raise RuntimeError("NCCL is not available in this torch build")
    config = dataclasses.replace(smoke_config(), seed=SEED)

    # a. one NCCL rank through the CLI, against the plain CLI
    argv = [sys.executable, "-m", "rsn_torch.cli.train",
            "reflect-sampling-nerf", "--data", f"sphere:res={FRAME_RES}",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16",
            "--max-num-iterations", str(MESH_STEPS), "--steps-per-log",
            str(MESH_STEPS // 2), "--seed", str(SEED)]
    group = ["--multihost", "--coordinator-address",
             f"127.0.0.1:{mesh_lib.free_port()}", "--num-processes", "1",
             "--process-id", "0"]
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = {name: os.path.join(tmp, name) for name in ("plain", "nccl")}
    procs = {name: subprocess.Popen(
        argv + ["--output-dir", out] + (group if name == "nccl" else []),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, out in runs.items()}
    states = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        lines = out.strip().splitlines()
        for line in [lines[0]] + lines[-2:]:
            print(f"  {name}: {line}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the {name} train CLI exited "
                               f"{proc.returncode}:\n{out[-4000:]}")
        (ckpt,) = [os.path.join(r, f) for r, _, fs in os.walk(runs[name])
                   for f in fs if f == f"step-{MESH_STEPS:09d}.pt"]
        states[name] = dict(checkpoint_tensors(ckpt_lib.load_checkpoint(
            ckpt)))
    if states["nccl"].keys() != states["plain"].keys():
        raise RuntimeError("the two checkpoints hold different tensors")
    differ = [k for k, v in states["plain"].items()
              if not torch.equal(v, states["nccl"][k])]
    print(f"  one NCCL rank against the plain CLI after {MESH_STEPS} steps: "
          f"{len(states['plain']) - len(differ)} of {len(states['plain'])} "
          f"checkpoint tensors equal bit for bit (both runs "
          f"{time.perf_counter() - start:.1f} s)", flush=True)
    if differ:
        raise RuntimeError(f"the one-rank NCCL run differs: {differ[:8]}")

    # the all-reduce's ms per step, on a one-rank NCCL group here
    mesh = mesh_lib.init_mesh(
        "cuda", coordinator_address=f"127.0.0.1:{mesh_lib.free_port()}",
        num_processes=1, process_id=0)
    real = mesh_lib.average_gradients
    events = []

    def timed(m, params):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        real(m, params)
        b.record()
        events[-1].append((a, b))

    mesh_lib.average_gradients = timed
    try:
        tr = Trainer(config, run_dir=os.path.join(tmp, "timed"), mesh=mesh)
        for _ in range(12):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            events.append([])
            a.record()
            tr.train_step()
            b.record()
            events[-1].append((a, b))
        torch.cuda.synchronize()
        reduce_ms = [e[0][0].elapsed_time(e[0][1]) for e in events[2:]]
        step_ms = [e[1][0].elapsed_time(e[1][1]) for e in events[2:]]
        numel = sum(p.numel() for p in tr.live_params())
        buf = torch.zeros(numel + len(tr.live_params()), device=mesh.device)
        raw = cuda_ms(lambda: dist.all_reduce(buf))
        print(f"  one NCCL rank, full-width step (median of steps 3-12): "
              f"average_gradients {statistics.median(reduce_ms):.4f} ms "
              f"(flatten, all_reduce of {buf.numel()} floats, / world, "
              f"grads back; dist.all_reduce alone {raw:.4f} ms, median of "
              f"10) beside the step's {statistics.median(step_ms):.4f} ms "
              f"(CUDA events; a one-rank all-reduce is a copy; {card})",
              flush=True)
    finally:
        mesh_lib.average_gradients = real
        mesh_lib.close(mesh)
    del tr
    torch.cuda.empty_cache()

    # b, c. two ranks on the one card
    print("  two ranks on the one card: NCCL refuses two ranks on one "
          "device (\"Duplicate GPU\"), so these ranks pass backend='gloo', "
          "their CUDA tensors staged through the host", flush=True)
    t0 = time.perf_counter()
    ranks = mesh_lib.launch(card_rank, 2, (config, tmp), device="cuda:0",
                            backend="gloo")
    print(f"  launch of 2 ranks: {time.perf_counter() - t0:.1f} s "
          f"(spawn, import, build the trainer, one step, two renders)")
    for r, res in enumerate(ranks):
        print(f"  rank {r}: step launches {res['step_launches']}; render "
              f"launches {res['render_launches']}", flush=True)
    for k in ("field_forward_v6", "field_backward_v6", "field_backward_v5",
              "train_blob", "field_backward_v4_wgrad"):
        if any(not res["step_launches"].get(k) for res in ranks):
            raise RuntimeError(f"{k} did not launch on a rank's step")
    if any(not res["render_launches"].get(k) for res in ranks
           for k in ("field_forward_v3", "field_forward_density")):
        raise RuntimeError("K1 or K2 did not launch on a rank's render")
    same = all(torch.equal(v, ranks[1]["field"][k])
               for k, v in ranks[0]["field"].items())
    ref = Trainer(config, run_dir=os.path.join(tmp, "ref"))
    grads = []
    for r in range(2):
        ref.generator.manual_seed(rank_seed(config.seed, r))
        _, groups = ref.forward_backward()
        grads.append([None if p.grad is None else p.grad.clone()
                      for p in ref.live_params()])
    for p, g0, g1 in zip(ref.live_params(), *grads):
        # a gradient no rank's graph reached stays None, as on one rank
        p.grad = None if g0 is None else (g0 + g1) / 2
    for opt, sched in groups:
        opt.step()
        sched.step()
    err = max(float((ranks[0]["field"][k].to(v.device) - v).abs().max())
              for k, v in ref.field.state_dict().items())
    print(f"  one step on two ranks: replicas equal bit for bit: {same}; "
          f"max |param - one process averaging both ranks' gradients| "
          f"{err:.3g} (limit {MESH_TOL})", flush=True)
    if not same or err > MESH_TOL:
        raise RuntimeError("the two ranks' step disagrees")
    del ref
    torch.cuda.empty_cache()

    device = torch.device("cuda", 0)
    field = Field(torch.Generator().manual_seed(SEED)).to(device).eval()
    orbit = render_cli.orbit_cameras(load_cameras(
        "synthetic", f"sphere:res={FRAME_RES}", "test"), 3).to(device)
    single = render_image(field, orbit, 0, config, rays_per_chunk=CHUNK,
                          product_only=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_image(field, orbit, 0, config, rays_per_chunk=CHUNK,
                 product_only=True)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        if set(res["render"]) != set(single) or any(
                not np.array_equal(res["render"][k], v)
                for k, v in single.items()):
            raise RuntimeError(f"rank {r}'s sharded frame differs from the "
                               "single-rank render")
    print(f"  sharded {FRAME_RES}x{FRAME_RES} product frame == the "
          f"single-rank render, bit for bit, on both ranks "
          f"({', '.join(sorted(single))}); seconds per rank "
          f"{[round(res['seconds'], 4) for res in ranks]}, of which the "
          f"gather of the rows (gloo, through the host) "
          f"{[round(res['gather_seconds'], 4) for res in ranks]}, beside "
          f"the single rank's {single_s:.4f} s (host clock, after a "
          f"warm-up render; {card})", flush=True)
    print(f"  phase 22: {time.perf_counter() - start:.1f} s", flush=True)


DISPATCH_STEPS = 60    # phase 23's runs: log every 10 (the controller's
                       # cadence too), an eval batch every 20, past the
                       # warmup's step 50
DISPATCH_TIMED = 20    # steps per timed turn (graphed, eager, eager,
                       # graphed)
DISPATCH_PROFILED = 5  # steps in each profiler window


def dispatch_config(route: str):
    """Phase 23's config of `route` (default, preset, camera): full width,
    the sphere at FRAME_RES, seed SEED, DISPATCH_STEPS steps."""
    if route == "preset":
        config = smoke_config("reflect-sampling-nerf-proposal",
                              use_pallas_proposal=True)
    else:
        config = smoke_config()
    if route == "camera":
        config = with_route(config, True, False)
    return dataclasses.replace(
        config, steps_per_log=10, steps_per_eval_batch=20,
        steps_per_eval_image=0, steps_per_save=0,
        max_num_iterations=DISPATCH_STEPS, seed=SEED)


def trainer_tensors(tr) -> dict:
    """Every tensor a trainer carries from step to step, on the host: the
    live parameters, each optimizer's state, the train and eval draws'
    generator states."""
    out = {f"param {i}": p.detach().cpu()
           for i, p in enumerate(tr.live_params())}
    for name, opt in (("field", tr.optimizer), ("proposal", tr.prop_optimizer),
                      ("camera", tr.cam_optimizer)):
        if opt is not None:
            for i, st in enumerate(opt.state.values()):
                for k, v in st.items():
                    out[f"{name} optimizer {i} {k}"] = v.detach().cpu()
    out["generator"] = tr.generator.get_state()
    out["eval generator"] = tr.eval_generator.get_state()
    return out


def differing(want: dict, got: dict) -> list:
    """The keys whose tensors differ (in any bit, or in shape / dtype)."""
    import torch

    return [k for k in want if k not in got
            or not torch.equal(want[k], got[k])] + sorted(set(got) - set(want))


def eager_steps(tr, until: int, force=None):
    """train_step from tr.step to `until` with the loop's host work: at
    each log step (also the controller's) the metrics and the
    controller's decision, at each eval-batch step the eval batch; force
    (step, bucket) sets the bucket there -> {step: the logged metrics,
    and the eval batch's}."""
    cfg = tr.config
    lines = {}
    while tr.step < until:
        if force and tr.step == force[0]:
            tr._set_reflect_fraction(force[1])
        m = tr.train_step()
        if tr.step % cfg.steps_per_log == 0:
            values = tr._host_metrics(m)
            tr._maybe_adapt_reflect_fraction(values)
            lines[tr.step] = values
        if tr.step % cfg.steps_per_eval_batch == 0:
            lines[tr.step] = dict(lines.get(tr.step, {}), **tr.eval_batch())
    return lines


def logged_losses(run_dir: str) -> dict:
    """{step: the values of its train and eval-batch lines} of a run's
    train_log.jsonl."""
    out = {}
    with open(os.path.join(run_dir, "train_log.jsonl")) as fh:
        for e in map(json.loads, fh):
            out.setdefault(e.pop("step"), {}).update(e)
    return out


def same_losses(eager: dict, graphed: dict) -> bool:
    """The graphed run's log lines hold the eager steps' values (losses,
    eval batches) bit for bit (json carries a float exactly), at the same
    steps."""
    return sorted(eager) == sorted(graphed) and all(
        graphed[s][k] == v for s, vals in eager.items()
        for k, v in vals.items() if k not in ("mask_fraction",
                                              "reflect_overflow"))


def device_idle_shares(windows, tmp: str) -> dict:
    """Each (tag, fn) of `windows` in turn under one torch.profiler
    session, each fn ending in a sync -> {tag: the share of its window,
    from its start to the sync, in which no kernel, copy or fill ran on
    the card (the union of their trace intervals)}.  One session: where
    the process holds CUDA graphs, CUPTI's re-initialisation after a
    session's teardown (TEARDOWN_CUPTI=1, which the trainer's profiler
    window sets) has traced no device work in a later session."""
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for tag, fn in windows:
            with torch.profiler.record_function(f"phase23 {tag}"):
                fn()
                torch.cuda.synchronize()
    path = os.path.join(tmp, "phase23_windows.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
              for e in events if e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")]
    out = {}
    for tag, _ in windows:
        (win,) = [e for e in events if e.get("name") == f"phase23 {tag}"
                  and e.get("cat") == "user_annotation"]
        lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        spans = sorted((max(lo, a), min(hi, b)) for a, b in device
                       if b > lo and a < hi)
        if not spans:
            raise RuntimeError(f"the {tag} window traced no device work")
        busy, end = 0.0, lo
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        out[tag] = 1.0 - busy / (hi - lo)
    return out


def timed_steps(tr, graphed: bool, steps: int):
    """`steps` steps of tr, replays of its captured step or eager
    train_step calls, from a sync to a sync -> (host ms per step, ms per
    step between CUDA events at the ends)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    if graphed:
        tr._run_chunk(steps)
    else:
        for _ in range(steps):
            tr.train_step()
    end.record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / steps,
            start.elapsed_time(end) / steps)


def dispatch_route(route: str, card, tmp: str):
    """Phase 23 on one route: DISPATCH_STEPS eager train_step calls (the
    loop's controller and reads), then train() graphed, from the same
    seed: every tensor and the logged losses bit for bit; the captures,
    replays, peaks, launches per step, ms per step in turns -> (the
    graphed trainer, its tensors after train())."""
    import torch

    from rsn_torch.engine.trainer import Trainer
    from rsn_torch.kernels import field_forward as ff

    config = dispatch_config(route)
    torch.cuda.reset_peak_memory_stats()
    eager = Trainer(config, run_dir=os.path.join(tmp, f"{route}_eager"))
    ff.reset_launch_counts()
    lines = eager_steps(eager, DISPATCH_STEPS)
    torch.cuda.synchronize()
    eager_launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    eager_peak = torch.cuda.max_memory_allocated()
    want = trainer_tensors(eager)
    del eager
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    run = os.path.join(tmp, f"{route}_graphed")
    tr = Trainer(config, run_dir=run)
    ff.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    graphed_launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    graphed_peak = torch.cuda.max_memory_allocated()
    got = trainer_tensors(tr)
    bad = differing(want, got)
    losses = same_losses(lines, logged_losses(run))
    print(f"  [{route}] train() graphed == {DISPATCH_STEPS} eager "
          f"train_step calls: {len(want)} tensors (every parameter, the "
          f"optimizers' state, the generators' states) bit for bit: "
          f"{not bad}{'' if not bad else ' ' + str(bad[:8])}; the logged "
          f"losses and eval batches at steps {sorted(lines)}: {losses}; "
          f"reflect bucket "
          f"{tr._reflect_frac:g}", flush=True)
    if bad or not losses:
        raise RuntimeError(f"{route}: the graphed steps differ from the "
                           "eager ones")
    if eager_launches != graphed_launches:
        raise RuntimeError(f"{route}: the replays' launch counts "
                           f"{graphed_launches} are not the eager steps' "
                           f"{eager_launches}")
    print(f"  [{route}] captured steps: " + "; ".join(
        f"bucket {frac:g}: capture {c.seconds:.4f} s, {c.replays} replays, "
        f"per step {c.launches}" for frac, c in tr.graphs.items())
        + f"; train() {train_s:.3f} s for {DISPATCH_STEPS} steps (host "
        f"clock, the captures and eval batches in it); launches in the run "
        f"== the eager steps' ({sum(graphed_launches.values())}); peak "
        f"memory allocated {graphed_peak / 2**30:.4f} GiB graphed, "
        f"{eager_peak / 2**30:.4f} GiB eager (torch.cuda."
        f"max_memory_allocated over the trainer's life; {card})",
        flush=True)

    # ms per step in turns on the graphed trainer (it keeps training);
    # each captured step's launches per replay
    turns = {"graphed": [], "eager": []}
    for way in ("graphed", "eager", "eager", "graphed"):
        ff.reset_launch_counts()
        turns[way].append(timed_steps(tr, way == "graphed", DISPATCH_TIMED))
        if way == "graphed":
            per = {k: v / DISPATCH_TIMED for k, v in ff.LAUNCHES.items() if v}
    print(f"  [{route}] ms per step, {DISPATCH_TIMED} steps a turn, turns "
          f"graphed, eager, eager, graphed: host clock graphed "
          f"{[round(h, 4) for h, _ in turns['graphed']]}, eager "
          f"{[round(h, 4) for h, _ in turns['eager']]}; CUDA events graphed "
          f"{[round(d, 4) for _, d in turns['graphed']]}, eager "
          f"{[round(d, 4) for _, d in turns['eager']]}; launches per step "
          f"the replays report {per} ({card})", flush=True)
    return tr, got


def graphed_dispatch_phase(card, tmp: str) -> None:
    """Phase 23: the train loop's chunks as replays of a captured step
    against eager steps, bit for bit, on the default method, the preset
    and the camera-on recompute route; a bucket changed mid-run; a save
    and restore into a new Trainer."""
    import torch

    from rsn_torch.engine.trainer import REFLECT_FRACTION_BUCKETS, Trainer

    phase(f"phase 23: graphed dispatch: train() of {DISPATCH_STEPS} "
          f"full-width steps as CUDA graph replays against eager steps "
          f"(default, preset, camera-on recompute route; a bucket change; "
          f"save and restore), sphere at {FRAME_RES}x{FRAME_RES}")
    start = time.perf_counter()
    trainers, uninterrupted = {}, None
    for route in ("default", "preset", "camera"):
        trainers[route], got = dispatch_route(route, card, tmp)
        if route == "default":
            uninterrupted = got
    # every route's idle share each way, after every timed turn (a trace
    # slows the launches after it)
    idle = device_idle_shares([
        (f"{route} {way}", lambda tr=tr, way=way: timed_steps(
            tr, way == "graphed", DISPATCH_PROFILED))
        for route, tr in trainers.items() for way in ("graphed", "eager")],
        tmp)
    print(f"  device idle share over {DISPATCH_PROFILED} steps each "
          f"(torch.profiler, one session): " + "; ".join(
              f"{tag} {v:.4f}" for tag, v in idle.items()) + f" ({card})",
          flush=True)
    del trainers
    torch.cuda.empty_cache()

    # a bucket forced at step 30: a second capture, the same bits
    config = dispatch_config("default")
    half = DISPATCH_STEPS // 2
    eager = Trainer(config, run_dir=os.path.join(tmp, "bucket_eager"))
    eager_steps(eager, half)
    # a bucket between the floor and 1.0 that the run is not in
    floor = config.pipeline.model.reflect_ray_fraction
    bucket = max(b for b in REFLECT_FRACTION_BUCKETS
                 if floor < b < 1.0 and b != eager._reflect_frac)
    eager_steps(eager, DISPATCH_STEPS, force=(half, bucket))
    want = trainer_tensors(eager)
    del eager
    tr = Trainer(config, run_dir=os.path.join(tmp, "bucket_graphed"))
    with contextlib.redirect_stdout(io.StringIO()):
        tr.train(half)
        tr._set_reflect_fraction(bucket)
        tr.train(DISPATCH_STEPS)
    bad = differing(want, trainer_tensors(tr))
    print(f"  bucket forced to {bucket:g} at step {half}: captured buckets "
          f"{sorted(tr.graphs)} ({[c.replays for c in tr.graphs.values()]} "
          f"replays), == the eager steps bit for bit: {not bad}"
          f"{'' if not bad else ' ' + str(bad[:8])}", flush=True)
    if bad or bucket not in tr.graphs or len(tr.graphs) < 2:
        raise RuntimeError("a bucket change broke the graphed steps")
    del tr
    torch.cuda.empty_cache()

    # save at step 30, restore into a new Trainer, graph again to step 60
    saving = dataclasses.replace(config, steps_per_save=half)
    first = Trainer(saving, run_dir=os.path.join(tmp, "saved"))
    with contextlib.redirect_stdout(io.StringIO()):
        first.train(half)
    ckpts = os.path.join(tmp, "saved", "checkpoints")
    del first
    resumed = Trainer(config, run_dir=os.path.join(tmp, "resumed"))
    resumed.restore(ckpts)
    with contextlib.redirect_stdout(io.StringIO()):
        resumed.train(DISPATCH_STEPS)
    bad = differing(uninterrupted, trainer_tensors(resumed))
    print(f"  saved at step {half} ({sorted(os.listdir(ckpts))}), restored "
          f"into a new Trainer, graphed to step {resumed.step}: every "
          f"tensor == the uninterrupted graphed run's, bit for bit: "
          f"{not bad}{'' if not bad else ' ' + str(bad[:8])}", flush=True)
    if bad or resumed.step != DISPATCH_STEPS or not resumed.graphs:
        raise RuntimeError("the restored run does not continue the "
                           "uninterrupted one")
    del resumed
    torch.cuda.empty_cache()
    print(f"  phase 23: {time.perf_counter() - start:.1f} s", flush=True)


def card_rank(mesh, config, tmp: str):
    """One of phase 22's two ranks on the card: one train step of the mesh
    path from zeroed launch counts, then orbit frame 0 rendered sharded
    (a warm-up, then the timed one) -> its launches, field, frame and
    seconds."""
    import torch

    from rsn_torch.cli import render as render_cli
    from rsn_torch.data.blender import load_cameras
    from rsn_torch.engine.trainer import Trainer, render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models.field import Field
    from rsn_torch.parallel import mesh as mesh_lib

    tr = Trainer(config, run_dir=os.path.join(tmp, "ranks"), mesh=mesh)
    ff.reset_launch_counts()
    tr.train_step()
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in ff.LAUNCHES.items() if v}
    state = {k: v.cpu() for k, v in tr.field.state_dict().items()}
    del tr
    field = Field(torch.Generator().manual_seed(SEED)).to(mesh.device).eval()
    orbit = render_cli.orbit_cameras(load_cameras(
        "synthetic", f"sphere:res={FRAME_RES}", "test"), 3).to(mesh.device)
    kw = dict(rays_per_chunk=CHUNK, product_only=True, mesh=mesh)
    render_image(field, orbit, 0, config, **kw)
    ff.reset_launch_counts()
    mesh_lib.barrier(mesh)
    t0 = time.perf_counter()
    out = render_image(field, orbit, 0, config, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # the gather alone: this rank's rows of the frame's columns
    rows = torch.zeros((-(-orbit.width * orbit.height // 2),
                        sum(v.shape[-1] for v in out.values())),
                       device=mesh.device)
    mesh_lib.barrier(mesh)
    t0 = time.perf_counter()
    mesh_lib.all_gather_rows(mesh, rows)
    torch.cuda.synchronize()
    return {"step_launches": step_launches, "field": state, "render": out,
            "seconds": seconds, "gather_seconds": time.perf_counter() - t0,
            "render_launches": {k: v for k, v in ff.LAUNCHES.items() if v}}


def checkpoint_tensors(tree, prefix=""):
    """Every tensor of a checkpoint, by its path."""
    import torch

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from checkpoint_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from checkpoint_tensors(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def run_cli(main, argv):
    """One CLI's main(argv) in this process, its output captured, from
    zeroed launch counts -> (its output, the kernels' launches)."""
    import torch

    from rsn_torch.kernels import field_forward as ff

    buf = io.StringIO()
    ff.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"{main.__module__} exited {rc}")
    return buf.getvalue(), dict(ff.LAUNCHES)


def decode_times(paths, card) -> None:
    """The native decoder's ms per 800x800 PNG (one thread, then the
    batch on every core) beside the zlib decoder's; its pixels == the
    zlib decoder's (RGB: v / 255 in float32 as the library computes it)."""
    import numpy as np

    from rsn_torch.data import native, png

    h, w = native.probe_png(paths[0])
    times = {}
    for label, threads in (("one thread", 1), ("all cores", 0)):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = native.decode_png_batch(paths, h, w, num_threads=threads)
            runs.append((time.perf_counter() - t0) / len(paths))
        times[label] = 1e3 * min(runs)
    t0 = time.perf_counter()
    pixels = [png.read_png(p)[1] for p in paths[:2]]
    zlib_ms = 1e3 * (time.perf_counter() - t0) / 2
    for got, px in zip(out, pixels):
        want = px.astype(np.float32) * (np.float32(1) / np.float32(255))
        if not np.array_equal(got, want):
            raise RuntimeError("the native decoder differs from the zlib "
                               "decoder")
    print(f"  PNG decode, {len(paths)} RGB PNGs of {w}x{h}: native "
          f"{times['one thread']:.4f} ms per PNG on one thread, "
          f"{times['all cores']:.4f} ms per PNG over the batch on "
          f"{os.cpu_count()} cores; the zlib decoder (numpy) "
          f"{zlib_ms:.4f} ms per PNG; native == zlib decoder bit for bit "
          f"(host CPU, best of 3; {card})", flush=True)


def user_path_phase(card, tmp: str) -> str:
    """Phase 19: write a Blender-format scene under `tmp`, then train,
    eval (with LPIPS), render (split, interpolate with a video) and
    convert through the CLIs a user calls, each from zeroed launch counts
    -> the trained run's dir."""
    import numpy as np
    import torch

    from rsn_torch import lpips as lpips_lib
    from rsn_torch import metrics as metrics_lib
    from rsn_torch.cli import convert as convert_cli
    from rsn_torch.cli import eval as eval_cli
    from rsn_torch.cli import render as render_cli
    from rsn_torch.cli import train as train_cli
    from rsn_torch.data.png import read_png
    from rsn_torch.data.synthetic import write_blender_scene
    from rsn_torch.engine import checkpoints as ckpt_lib
    from rsn_torch.utils import gif

    phase(f"phase 19: the user path on a Blender-format scene at "
          f"{FRAME_RES}x{FRAME_RES}: train, eval with LPIPS, render, convert")
    scene = write_blender_scene(os.path.join(tmp, "scene"), USER_CAMS,
                                FRAME_RES, FRAME_RES)
    decode_times(sorted(os.path.join(scene, split, f)
                        for split in ("train", "val", "test")
                        for f in os.listdir(os.path.join(scene, split))),
                 card)

    text, launches = run_cli(train_cli.main, [
        "reflect-sampling-nerf", "--pipeline.datamanager.dataparser",
        "blender", "--pipeline.datamanager.data", scene,
        "--pipeline.model.compute-dtype", "bfloat16",
        "--max-num-iterations", str(USER_STEPS), "--steps-per-log", "1",
        "--seed", str(SEED), "--output-dir", os.path.join(tmp, "out")])
    print("\n".join("  " + ln for ln in text.splitlines()))
    run = re.search(r"run dir: (\S+)", text).group(1)
    train = {k: launches[k] for k in TRAIN_KERNELS}
    with open(os.path.join(run, "train_log.jsonl")) as fh:
        log = [json.loads(line) for line in fh]
    print(f"  train launches: {train}; {USER_STEPS} steps, "
          f"rays_per_sec {log[-1]['rays_per_sec']:.1f} at the last line "
          f"({card})")
    if min(train.values()) <= 0:
        raise RuntimeError("a kernel of the train path never launched")
    if len(log) != USER_STEPS or not all(
            np.isfinite(e["total_loss"]) for e in log):
        raise RuntimeError("expected a finite log line per step")

    # eval with a seeded LPIPS file; each LPIPS call's images recorded
    weights = os.path.join(tmp, "lpips_vgg.pth")
    torch.save(lpips_lib.export_torch_state_dict(lpips_lib.LPIPS(
        torch.Generator().manual_seed(SEED))), weights)
    seen = []
    real_lpips = metrics_lib.lpips

    def recording(pred, gt, net=None):
        value = real_lpips(pred, gt, net)
        seen.append((pred, gt, value))
        return value

    os.environ["RSN_LPIPS_WEIGHTS"] = weights
    metrics_lib.lpips = recording
    try:
        text, launches = run_cli(eval_cli.main, [
            "--load-dir", run, "--max-images", "2"])
    finally:
        metrics_lib.lpips = real_lpips
        del os.environ["RSN_LPIPS_WEIGHTS"]
    print("\n".join("  " + ln for ln in text.splitlines()))
    with open(os.path.join(run, "eval.json")) as fh:
        res = json.load(fh)
    if sorted(res) != ["coarse_psnr", "fine_lpips", "fine_psnr",
                       "fine_ssim", "psnr"] or not all(
                           np.isfinite(v) for v in res.values()):
        raise RuntimeError(f"eval.json: {res}")
    k1, k2 = launches["field_forward_v3"], launches["field_forward_density"]
    cpu = float(lpips_lib.load_torch_weights(weights)(
        torch.as_tensor(seen[0][0]), torch.as_tensor(seen[0][1])))
    per_image = [float(x) for x in re.findall(r": ([\d.]+) s \(",
                                              text)]
    lp_ms = [float(x) for x in re.findall(r"LPIPS ([\d.]+) ms", text)]
    print(f"  eval: K1 {k1} launches, K2 {k2} (a full render: K1 on "
          f"all four passes); image 0's LPIPS on the card "
          f"{seen[0][2]:.9g}, on the CPU {cpu:.9g} (|diff| "
          f"{abs(seen[0][2] - cpu):.3g}, limit {LPIPS_TOL}); "
          f"{per_image} s per image, LPIPS {lp_ms} ms at "
          f"{FRAME_RES}x{FRAME_RES} (host clock ending in a device "
          f"sync; {card})", flush=True)
    if k1 <= 0 or k2 != 0 or len(seen) != 2:
        raise RuntimeError("eval did not run K1 on every pass of "
                           "two images")
    if abs(seen[0][2] - cpu) > LPIPS_TOL:
        raise RuntimeError("LPIPS on the card differs from the CPU's")

    # a bare render call: split mode, the three panels
    text, launches = run_cli(render_cli.main, [
        "--load-dir", run, "--max-images", "1"])
    print("\n".join("  " + ln for ln in text.splitlines()))
    panels = os.path.join(run, "renders_test")
    for name, width in (("img", 3), ("accumulation", 2), ("depth", 2)):
        mode, px = read_png(os.path.join(panels, f"00000-{name}.png"))
        if px.shape != (FRAME_RES, width * FRAME_RES, 3) or \
                px.min() == px.max():
            raise RuntimeError(f"split panel {name}: wrong or constant")
    print(f"  split: three panels; launches K1 "
          f"{launches['field_forward_v3']}, K2 "
          f"{launches['field_forward_density']} ({card})")
    if launches["field_forward_v3"] <= 0 or \
            launches["field_forward_density"] != 0:
        raise RuntimeError("a split render runs K1 on all four passes")

    # a generated path with its video
    text, launches = run_cli(render_cli.main, [
        "--load-dir", run, "--mode", "interpolate", "--num-frames", "4",
        "--video", "--downscale-factor", "4"])
    print("\n".join("  " + ln for ln in text.splitlines()))
    out = os.path.join(run, "renders_interpolate")
    side = FRAME_RES // 4
    frames = [read_png(os.path.join(out, f"frame_{i:05d}.png"))[1]
              for i in range(4)]
    video = re.search(r"wrote (\S+\.(?:gif|mp4))", text).group(1)
    if video.endswith(".gif"):
        decoded, _ = gif.read_gif(video)
        if len(decoded) != 4:
            raise RuntimeError("the GIF does not hold 4 frames")
        for a, b in zip(decoded, frames):
            err = np.abs(a.astype(np.float64) - b)
            if a.shape != (side, side, 3) or (
                    err > np.asarray(gif.STEP) / 2 + 1e-9).any():
                raise RuntimeError("a GIF frame is off its PNG frame")
    elif os.path.getsize(video) == 0:
        raise RuntimeError("empty mp4")
    print(f"  interpolate: 4 frames of {side}x{side} and {video} "
          f"({os.path.getsize(video)} bytes); launches K2 "
          f"{launches['field_forward_density']}, K1 "
          f"{launches['field_forward_v3']} ({card})")
    if launches["field_forward_density"] <= 0 or \
            launches["field_forward_v3"] <= 0:
        raise RuntimeError("a generated path runs K2 and K1")

    # convert: export -> import -> export
    a, b = os.path.join(tmp, "a.ckpt"), os.path.join(tmp, "b.ckpt")
    run2 = os.path.join(tmp, "imported")
    for argv in (["--load-dir", run, "--to-torch", a],
                 ["--torch-ckpt", a, "--output", run2, "--dataparser",
                  "blender", "--data", scene],
                 ["--load-dir", run2, "--to-torch", b]):
        text, _ = run_cli(convert_cli.main, argv)
        print("  " + text.strip())
    sa = torch.load(a, weights_only=False)
    sb = torch.load(b, weights_only=False)
    trained = ckpt_lib.export_torch_state_dict(ckpt_lib.load_checkpoint(
        ckpt_lib.latest_checkpoint(os.path.join(run, "checkpoints")))[
            "field"])
    same = (sa["step"] == sb["step"] == USER_STEPS
            and list(sa["pipeline"]) == list(sb["pipeline"])
            and all(torch.equal(v, sb["pipeline"][k])
                    and np.array_equal(v.numpy(),
                                       trained[k[len("_model."):]])
                    for k, v in sa["pipeline"].items()))
    print(f"  convert: export -> import -> export, "
          f"{len(sa['pipeline'])} tensors equal bit for bit and equal "
          f"to the trained field: {same}")
    if not same:
        raise RuntimeError("convert is not the identity")
    return run


MESH_RES = 256      # phase 20's export mesh (rsn's default resolution)
MESH_QUANTILE = 0.999  # its iso: this quantile of the density at random
                    # points; the 10-step field is noise at grid scale
                    # (the point IPE's 2^16 octave), so a mid-range iso
                    # would cut most of the 16.6 M cubes
QUERY_TOL = 1e-5    # a grid plane on the card against the CPU, fp32
                    # (tests/test_torch_export.py's query tolerance)
VIEW_POSE = {"theta": 0.5, "phi": 0.3, "r": 1.0}


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Count the calls of module.name while the block runs -> [count]."""
    count = [0]
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield count
    finally:
        setattr(module, name, real)


def seconds_of(pattern: str, text: str):
    return [float(x) for x in re.findall(pattern, text)]


def export_viewer_phase(run: str, card) -> None:
    """Phase 20: the export CLI's four modes and a websocket viewer
    session on phase 19's trained run, each from zeroed launch counts."""
    import socket
    import threading
    from http.server import ThreadingHTTPServer
    import urllib.request

    import numpy as np
    import torch

    from rsn_torch.cli import export as export_cli
    from rsn_torch.cli import render as render_cli
    from rsn_torch.cli import viewer as viewer_cli
    from rsn_torch.cli.run_io import load_run_full
    from rsn_torch.core.mesh import read_ply
    from rsn_torch.data.cameras import Cameras
    from rsn_torch.data.png import read_png
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.models import model as model_lib
    from rsn_torch.models.model import final_rgb
    from rsn_torch.utils import websocket as ws

    phase(f"phase 20: export (mesh, pointcloud, tsdf, cameras) and a "
          f"viewer session on phase 19's run at {FRAME_RES}x{FRAME_RES}")
    field, config, _, _ = load_run_full(run, "cuda")
    field_cpu, _, _, _ = load_run_full(run, "cpu")
    dtype = export_cli.query_dtype(config)

    # one grid plane on the card against the CPU, fp32
    ax = torch.from_numpy(np.linspace(-1.5, 1.5, MESH_RES, dtype=np.float32))
    i = MESH_RES // 2
    gpu = export_cli.density_plane(field, ax.cuda(), i, torch.float32).cpu()
    cpu = export_cli.density_plane(field_cpu, ax, i, torch.float32)
    err = float((gpu - cpu).abs().max())
    print(f"  grid plane {i} ({MESH_RES}x{MESH_RES} points, fp32): card "
          f"against CPU max |err| {err:.6g} (limit {QUERY_TOL})")
    if not err <= QUERY_TOL:
        raise RuntimeError("the card's grid plane differs from the CPU's")

    # mesh: the iso at a high quantile of the density at random points
    pts = torch.rand(1 << 20, 3, generator=torch.Generator().manual_seed(
        SEED)).cuda() * 3.0 - 1.5
    dens = export_cli._chunked(lambda p: export_cli.query(field, p, dtype)[
        "density"], pts)
    iso = float(torch.quantile(dens[::4].float(), MESH_QUANTILE))
    print(f"  density at 2^20 random points ({dtype}): min "
          f"{float(dens.min()):.6g}, median {float(dens.median()):.6g}, max "
          f"{float(dens.max()):.6g}; iso (quantile {MESH_QUANTILE}) "
          f"{iso:.6g}")
    ff.reset_launch_counts()
    text, launches = run_cli(export_cli.main, [
        "mesh", "--load-dir", run, "--resolution", str(MESH_RES),
        "--density-threshold", repr(iso)])
    print("\n".join("  " + ln for ln in text.splitlines()))
    grid_s = seconds_of(r"grid \d+\^3 on \w+: ([\d.]+) s", text)
    iso_s = seconds_of(r"isosurface on the host: ([\d.]+) s", text)
    col_s = seconds_of(r"colors and normals on \w+: ([\d.]+) s", text)
    v, f, c, n = read_ply(os.path.join(run, "exports", "mesh.ply"))
    print(f"  mesh: {len(v)} vertices, {len(f)} faces; grid {grid_s} s "
          f"(card), isosurface {iso_s} s (host), colors and normals "
          f"{col_s} s (card); launches {sum(launches.values())} (the plain "
          f"field, as rsn queries it; {card})", flush=True)
    if not (len(v) > 0 and len(f) > 0 and len(grid_s) == len(iso_s)
            == len(col_s) == 1):
        raise RuntimeError("export mesh: an empty mesh or a missing time")
    if np.abs(np.linalg.norm(n, axis=-1) - 1.0).max() > 1e-3 or \
            c.min() < 0 or c.max() > 1 or not np.isfinite(v).all():
        raise RuntimeError("export mesh: normals not unit or colors out of "
                           "[0, 1]")

    # pointcloud and tsdf: full renders of two images, K1 on all 4 passes
    chunks = -(-FRAME_RES * FRAME_RES // CHUNK)
    for mode, extra, pattern in (
            ("pointcloud", [], r"backprojected \d+/\d+: ([\d.]+) s"),
            ("tsdf", ["--resolution", "128"], r"rendered \d+/\d+: ([\d.]+) s")):
        with counting_calls(model_lib, "get_outputs") as calls:
            t0 = time.perf_counter()
            text, launches = run_cli(export_cli.main, [
                mode, "--load-dir", run, "--max-images", "2"] + extra)
            wall = time.perf_counter() - t0
        print("\n".join("  " + ln for ln in text.splitlines()))
        per_image = seconds_of(pattern, text)
        v, f, c, n = read_ply(os.path.join(run, "exports", f"{mode}.ply"))
        k1, k2 = (launches["field_forward_v3"],
                  launches["field_forward_density"])
        print(f"  {mode}: {len(v)} vertices, "
              f"{0 if f is None else len(f)} faces; {per_image} s per image "
              f"(render), {wall:.4f} s the whole call; K1 {k1} launches over "
              f"{calls[0]} chunk renders ({chunks} chunks an image), K2 "
              f"{k2} ({card})", flush=True)
        if len(per_image) != 2 or len(v) == 0 or not np.isfinite(v).all():
            raise RuntimeError(f"export {mode}: no output or no times")
        if (k1 != 4 * calls[0] or k2 != 0 or calls[0] < 2 * chunks
                or calls[0] % chunks):
            raise RuntimeError(f"export {mode}: K1 must run on all four "
                               "passes of every chunk of two images")
        if c.min() < 0 or c.max() > 1 or (mode == "pointcloud" and np.abs(
                np.linalg.norm(n, axis=-1) - 1.0).max() > 1e-3):
            raise RuntimeError(f"export {mode}: colors or normals wrong")
    text, _ = run_cli(export_cli.main, ["cameras", "--load-dir", run])
    with open(os.path.join(run, "exports", "cameras.json")) as fh:
        doc = json.load(fh)
    if len(doc["frames"]) != USER_CAMS or doc["frames"][0]["w"] != FRAME_RES:
        raise RuntimeError("export cameras: wrong document")
    print(f"  cameras: {len(doc['frames'])} frames, "
          f"{doc['frames'][0]['w']}x{doc['frames'][0]['h']}")

    # the viewer in process: _State, the server, a websocket client
    viewer_cli.load_state(run, "cuda", downscale=2)
    failures = []
    print("  " + "\n  ".join(io_lines(
        lambda: viewer_cli.warm_up(failures=failures))) + f" ({card})")
    if failures:
        raise RuntimeError("viewer: the warm-up render failed") \
            from failures[0]
    server = ThreadingHTTPServer(("127.0.0.1", 0), viewer_cli._Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        ff.reset_launch_counts()
        sock = socket.create_connection((host, port), timeout=300)
        try:
            ws.client_handshake(sock, f"{host}:{port}")
            rf, wf = sock.makefile("rb"), sock.makefile("wb")
            t0 = time.perf_counter()
            sock.sendall(ws.encode_frame(json.dumps(dict(
                type="pose", mode="rgb", **VIEW_POSE)).encode(), ws.OP_TEXT,
                mask=True))
            frames, ms = [], []
            for _ in range(3):
                op, payload = ws.read_message(rf, wf)
                t1 = time.perf_counter()
                ms.append(1e3 * (t1 - t0))
                t0 = t1
                frames.append(payload)
            sock.sendall(ws.encode_frame(b"\x03\xe8", ws.OP_CLOSE, mask=True))
        finally:
            sock.close()
        torch.cuda.synchronize()
        session = dict(ff.LAUNCHES)
        sides = []
        for q, payload in enumerate(frames):
            if payload[0] != q:
                raise RuntimeError(f"viewer: frame {q} has quality byte "
                                   f"{payload[0]}")
            sides.append(png_bytes_pixels(payload[1:]).shape)
        want = [(FRAME_RES // 2 // d, FRAME_RES // 2 // d, 3)
                for d in viewer_cli._QUALITY_DIVISORS]
        print(f"  viewer websocket: frames {sides} (quality bytes 0, 1, 2), "
              f"{[round(x, 4) for x in ms]} ms per level from the pose (host "
              f"clock, the client's receipt); launches K2 "
              f"{session['field_forward_density']}, K1 "
              f"{session['field_forward_v3']} ({card})", flush=True)
        if sides != want:
            raise RuntimeError(f"viewer: frame sizes {sides}, want {want}")
        if session["field_forward_density"] <= 0 or \
                session["field_forward_v3"] <= 0:
            raise RuntimeError("viewer: K2 and K1 must both launch")

        # the q=2 frame == the product render at the same pose, bit for bit
        pose = viewer_cli._pose_matrix(**VIEW_POSE)
        ref = viewer_cli._State.cameras
        cams = Cameras(torch.from_numpy(np.ascontiguousarray(
            pose[None, :3, :4])), ref.fx[:1], ref.fy[:1], ref.cx[:1],
            ref.cy[:1], width=ref.width, height=ref.height).to("cuda")
        out = render_image(field, cams, 0, config,
                           rays_per_chunk=preferred_eval_chunk(config,
                                                               "cuda"),
                           product_only=True,
                           reflect_memo=viewer_cli._State.reflect_memo)
        want_px = (np.clip(final_rgb(out), 0, 1) * 255).astype(np.uint8)
        got_px = png_bytes_pixels(frames[2][1:])
        with urllib.request.urlopen(
                f"http://{host}:{port}/render?theta={VIEW_POSE['theta']}"
                f"&phi={VIEW_POSE['phi']}&r={VIEW_POSE['r']}&q=2",
                timeout=300) as rsp:
            http_px = png_bytes_pixels(rsp.read())
        print(f"  q=2 frame == the product render at the pose, bit for bit: "
              f"{np.array_equal(got_px, want_px)}; GET /render == it: "
              f"{np.array_equal(http_px, want_px)}; {len(np.unique(got_px))} "
              f"distinct values")
        if not (np.array_equal(got_px, want_px)
                and np.array_equal(http_px, want_px)):
            raise RuntimeError("viewer: a frame differs from the render")

        # POST /export_path, then the render CLI's --mode path on it
        req = urllib.request.Request(
            f"http://{host}:{port}/export_path", method="POST",
            data=json.dumps([VIEW_POSE, dict(VIEW_POSE, theta=1.0)]).encode())
        with urllib.request.urlopen(req, timeout=60) as rsp:
            reply = json.loads(rsp.read())
    finally:
        server.shutdown()
        server.server_close()
    out_dir = os.path.join(run, "renders_viewer_path")
    text, launches = run_cli(render_cli.main, [
        "--load-dir", run, "--mode", "path", "--camera-path", reply["path"],
        "--output-dir", out_dir])
    print("\n".join("  " + ln for ln in text.splitlines()))
    frames = sorted(os.listdir(out_dir))
    shapes = {read_png(os.path.join(out_dir, f))[1].shape for f in frames}
    print(f"  viewer path {os.path.basename(reply['path'])}: "
          f"{reply['num_frames']} poses -> render --mode path {frames} "
          f"{shapes}; launches K2 {launches['field_forward_density']}, K1 "
          f"{launches['field_forward_v3']}")
    if reply["num_frames"] != 2 or len(frames) != 2 or shapes != {
            (FRAME_RES // 2, FRAME_RES // 2, 3)}:
        raise RuntimeError("viewer: the exported path did not render")


JPEG_DIR = os.path.join(REPO, "tests", "golden", "jpeg")
JPEG_KINDS_DIR = os.path.join(REPO, "tests", "golden", "jpeg_kinds")
JPEG_STEPS = 10     # phase 21's train run on the JPEG capture
JPEG_PROFILE = (3, 3)  # its profiler window: the start step, the steps
RADAM_STEP = "Optimizer.step#RAdam.step"


def hand_written_kernels() -> set:
    """The name of every __global__ function under rsn_torch/csrc."""
    src = os.path.join(REPO, "rsn_torch", "csrc")
    names = set()
    for fname in os.listdir(src):
        with open(os.path.join(src, fname)) as fh:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", fh.read()))
    return names


def jpeg_decode_check(card, png_dir: str):
    """Every committed fixture decoded to PIL's recorded digest; ms per
    800x800 JPEG frame beside the native PNG decoder's ms per PNG of
    phase 19's scene (host CPU, one thread, best of 3) -> the frames."""
    import hashlib

    import numpy as np

    from rsn_torch.data import native
    from rsn_torch.data.jpeg import read_jpeg

    with open(os.path.join(JPEG_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    for fname, want in sorted(recorded["files"].items()):
        mode, arr = read_jpeg(os.path.join(JPEG_DIR, fname))
        got = {"mode": mode, "shape": list(arr.shape),
               "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        if got != want:
            raise RuntimeError(f"{fname}: decoded to {got}, PIL's decode "
                               f"is {want}")
    frames = [os.path.join(JPEG_DIR, f) for f in sorted(recorded["files"])
              if f.startswith("frame_")]
    pngs = sorted(os.path.join(root, f)
                  for root, _, files in os.walk(png_dir)
                  for f in files if f.endswith(".png"))
    h, w = native.probe_png(pngs[0])
    jpeg_runs, png_runs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for f in frames:
            read_jpeg(f)
        jpeg_runs.append((time.perf_counter() - t0) / len(frames))
        t0 = time.perf_counter()
        native.decode_png_batch(pngs, h, w, num_threads=1)
        png_runs.append((time.perf_counter() - t0) / len(pngs))
    print(f"  {len(recorded['files'])} JPEG fixtures == PIL "
          f"{recorded['pil']} / libjpeg-turbo {recorded['libjpeg_turbo']}'s "
          f"decode (mode, shape, sha256); {1e3 * min(jpeg_runs):.4f} ms per "
          f"{FRAME_RES}x{FRAME_RES} JPEG frame (quality 90, 4:2:0, "
          f"{len(frames)} frames), native PNG decoder "
          f"{1e3 * min(png_runs):.4f} ms per {w}x{h} PNG ({len(pngs)} PNGs) "
          f"(host CPU, one thread, best of 3; {card})", flush=True)
    jpeg_kinds_check(card, 1e3 * min(jpeg_runs))
    return frames


def jpeg_kinds_check(card, baseline_ms: float) -> None:
    """Every committed jpeg_kinds fixture decoded to PIL's recorded digest;
    one 800x800 frame of each kind that PIL reads but does not write,
    written by the fixtures' numpy writer, decoded and timed (host CPU,
    one thread, best of 3) beside the baseline JPEG frame's ms."""
    import hashlib

    import numpy as np

    from rsn_torch.data.jpeg import read_jpeg

    writer = load_writer("jpeg_kinds_writer",
                         os.path.join(JPEG_KINDS_DIR, "write_fixtures.py"))
    with open(os.path.join(JPEG_KINDS_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    for fname, want in sorted(recorded["files"].items()):
        mode, arr = read_jpeg(os.path.join(JPEG_KINDS_DIR, fname))
        got = {"mode": mode, "shape": list(arr.shape),
               "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        if got != want:
            raise RuntimeError(f"jpeg_kinds/{fname}: decoded to {got}, PIL's "
                               f"decode is {want}")
    print(f"  {len(recorded['files'])} jpeg_kinds fixtures == PIL "
          f"{recorded['pil']} / libjpeg-turbo {recorded['libjpeg_turbo']}'s "
          f"decode (mode, shape, sha256)", flush=True)
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (ncomp, opts) in writer.TIMED_KINDS.items():
            px = writer.frame_pixels(FRAME_RES, ncomp)
            path = os.path.join(tmp, f"{name}.jpg")
            t0 = time.perf_counter()
            data = writer.write_jpeg(px, **opts)
            write_s = time.perf_counter() - t0
            with open(path, "wb") as fh:
                fh.write(data)
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                mode, arr = read_jpeg(path)
                runs.append(time.perf_counter() - t0)
            want_shape = (FRAME_RES, FRAME_RES) + ((ncomp,) if ncomp > 1
                                                   else ())
            if mode != writer.MODES[ncomp] or arr.shape != want_shape:
                raise RuntimeError(f"{name}: {mode} {arr.shape}")
            if opts.get("coding") == "lossless" and not np.array_equal(
                    arr, px):
                raise RuntimeError(f"{name}: the lossless frame is not "
                                   "the writer's pixels")
            if name == "cmyk":
                err = np.abs((255 - arr.astype(np.int64)) - px).mean()
                if err > 3:
                    raise RuntimeError(f"cmyk: mean error {err:.3f}")
            times[name] = (1e3 * min(runs), len(data), write_s)
    print(f"  ms per {FRAME_RES}x{FRAME_RES} frame by kind (host CPU, one "
          f"thread, best of 3; baseline 4:2:0 quality 90 "
          f"{baseline_ms:.4f}): " + ", ".join(
              f"{k} {ms:.4f} ({size} bytes, written in {ws:.2f} s)"
              for k, (ms, size, ws) in times.items()) + f" ({card})",
          flush=True)


def write_capture(frames, out_dir: str) -> str:
    """A nerfstudio-format capture: the frame files under images/ and a
    transforms.json with the synthetic train cameras' poses and
    intrinsics (the frames are make_synthetic_dataset's images)."""
    import shutil

    import numpy as np

    from rsn_torch.data.synthetic import make_synthetic_cameras

    cams = make_synthetic_cameras(len(frames), FRAME_RES, FRAME_RES)
    os.makedirs(os.path.join(out_dir, "images"))
    meta = {"camera_model": "OPENCV", "w": FRAME_RES, "h": FRAME_RES,
            "frames": []}
    for i, path in enumerate(frames):
        name = os.path.join("images", os.path.basename(path))
        shutil.copyfile(path, os.path.join(out_dir, name))
        pose = np.eye(4)
        pose[:3, :4] = cams.camera_to_worlds[i].numpy()
        meta["frames"].append({
            "file_path": name, "transform_matrix": pose.tolist(),
            "fl_x": float(cams.fx[i]), "fl_y": float(cams.fy[i]),
            "cx": float(cams.cx[i]), "cy": float(cams.cy[i])})
    with open(os.path.join(out_dir, "transforms.json"), "w") as fh:
        json.dump(meta, fh)
    return out_dir


def check_trace(prof_dir: str, card) -> None:
    """One Chrome trace over JPEG_PROFILE's steps: a RAdam step for each
    eager step and a REPLAY_SPAN for each replay of a captured step, one
    or the other for each step, and CUDA kernel events of the hand-written
    kernels (none: the window saw no device work, and the phase
    raises)."""
    from rsn_torch.engine.trainer import REPLAY_SPAN

    start, num = JPEG_PROFILE
    traces = sorted(os.listdir(prof_dir))
    want = f"trace_step{start:06d}_to_step{start + num:06d}.json"
    if traces != [want]:
        raise RuntimeError(f"profile dir holds {traces}, not [{want}]")
    with open(os.path.join(prof_dir, want)) as fh:
        events = json.load(fh)["traceEvents"]
    # the host's annotation; a CUDA trace repeats it on the device's
    # timeline as "gpu_user_annotation"
    radam, replays = (sum(e.get("name") == name
                          and e.get("cat") == "user_annotation"
                          for e in events) for name in (RADAM_STEP,
                                                        REPLAY_SPAN))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = re.compile(r"\b(" + "|".join(sorted(hand_written_kernels()))
                      + r")\b")
    by_name, ours_us = {}, 0.0
    for e in kernels:
        m = ours.search(e.get("name", ""))
        if m:
            by_name[m.group(1)] = by_name.get(m.group(1), 0) + 1
            ours_us += float(e.get("dur", 0.0))
    all_us = sum(float(e.get("dur", 0.0)) for e in kernels)
    print(f"  trace {want}: {radam} {RADAM_STEP} events, {replays} "
          f"{REPLAY_SPAN} events, {len(kernels)} "
          f"CUDA kernel events, {sum(by_name.values())} of them "
          f"hand-written ({ours_us / max(all_us, 1e-9):.2%} of the kernel "
          f"time): {dict(sorted(by_name.items()))} ({card})", flush=True)
    if radam + replays != num:
        raise RuntimeError(f"the trace holds {radam} RAdam steps and "
                           f"{replays} replays, not {num} steps")
    if not by_name:
        raise RuntimeError("the trace holds no kernel event of the "
                           "hand-written kernels: the window saw no "
                           "device work")


def launch_us() -> float:
    """The host's microseconds per launch of a one-element in-place add
    on the card: the median of 5 loops of 20,000, each ending in a
    sync."""
    import statistics

    import torch

    x = torch.zeros(1, device="cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20000):
            x.add_(1)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / 20000 * 1e6)
    return statistics.median(runs)


def capture_train_run(card, scene: str, tmp: str, name: str,
                      profiled: bool):
    """`python -m rsn_torch.cli.train` for JPEG_STEPS bf16 steps on a
    nerfstudio capture (phase 21's JPEGs, phase 24's TIFFs) with --vis
    tensorboard, and with profiled the profiler
    window over JPEG_PROFILE's steps (its trace checked); its launches of
    the train kernels, finite losses, no tb writer without tensorboardX
    -> (its run dir, host ms per step from the cumulative rays_per_sec)."""
    import importlib.util

    import numpy as np

    start, num = JPEG_PROFILE
    tag = name.replace(" ", "_")
    prof_dir = os.path.join(tmp, f"capture_profile_{tag}")
    argv = [
        "reflect-sampling-nerf", "--pipeline.datamanager.dataparser",
        "nerfstudio", "--pipeline.datamanager.data", scene,
        # nerfstudio scales the camera ring into the unit ball; back to
        # radius 4, where the sphere lies between the collider's planes
        "--pipeline.datamanager.scale-factor", "4.0",
        "--pipeline.model.compute-dtype", "bfloat16",
        "--max-num-iterations", str(JPEG_STEPS), "--steps-per-log", "1",
        "--seed", str(SEED),
        "--output-dir", os.path.join(tmp, f"capture_out_{tag}"),
        "--vis", "tensorboard"]
    if profiled:
        argv += ["--profile-dir", prof_dir, "--profile-start-step",
                 str(start), "--profile-num-steps", str(num)]
    from rsn_torch.cli import train as train_cli

    text, launches = run_cli(train_cli.main, argv)
    print("\n".join(f"  [{name}] " + ln for ln in text.splitlines()))
    run = re.search(r"run dir: (\S+)", text).group(1)
    train = {k: launches[k] for k in TRAIN_KERNELS}
    with open(os.path.join(run, "train_log.jsonl")) as fh:
        log = [json.loads(line) for line in fh]
    with open(os.path.join(run, "config.json")) as fh:
        rays = json.load(fh)["pipeline"]["datamanager"][
            "train_num_rays_per_batch"]
    # rays_per_sec runs from the start of train(), after a device sync,
    # and each log line follows one (steps_per_log 1)
    ends = np.array([e["step"] * rays / e["rays_per_sec"] for e in log])
    step_ms = 1e3 * np.diff(ends, prepend=0.0)
    print(f"  [{name}] train launches: {train}; {JPEG_STEPS} steps, "
          f"rays_per_sec {log[-1]['rays_per_sec']:.1f} at the last line "
          f"({card})", flush=True)
    if min(train.values()) <= 0:
        raise RuntimeError("a kernel of the train path never launched")
    if len(log) != JPEG_STEPS or not all(
            np.isfinite(e["total_loss"]) for e in log):
        raise RuntimeError("expected a finite log line per step")
    has_tbx = importlib.util.find_spec("tensorboardX") is not None
    opened = os.path.isdir(os.path.join(run, "tb"))
    print(f"  [{name}] vis tensorboard: tensorboardX importable {has_tbx}, "
          f"writer dir opened {opened}")
    if opened != has_tbx:
        raise RuntimeError("the tensorboard writer does not follow "
                           "tensorboardX's presence")
    if profiled:
        check_trace(prof_dir, card)
    elif os.path.exists(prof_dir):
        raise RuntimeError("a run without --profile-dir wrote a trace")
    return run, step_ms


def jpeg_phase(card, tmp: str, png_dir: str) -> None:
    """Phase 21: the JPEG decoder on this host, then a nerfstudio capture
    of JPEG frames through the train CLI (vis tensorboard; without the
    profiler window, with it, and without it again) and the eval CLI,
    each from zeroed launch counts."""
    import numpy as np

    from rsn_torch.data.blender import load_dataset

    phase(f"phase 21: JPEG frames: the fixtures against PIL's digests, "
          f"then train (tensorboard; without, with and again without the "
          f"profiler window) and eval on a nerfstudio capture of "
          f"{FRAME_RES}x{FRAME_RES} JPEGs")
    frames = jpeg_decode_check(card, png_dir)
    scene = write_capture(frames, os.path.join(tmp, "jpeg_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    print(f"  load_nerfstudio: {ds.images.shape[0]} train frames of "
          f"{ds.images.shape[2]}x{ds.images.shape[1]} in {load_s:.4f} s "
          f"(host clock)")

    # the same run without the window, before and after it: whether the
    # window's cost outlasts it (the steps after it against the same steps
    # of a run that never traced)
    # and the host's cost of one launch before the first trace and after
    # each run (a CUPTI hook left attached would raise it)
    runs, launch = {}, {"before the runs": launch_us()}
    for name, profiled in (("plain", False), ("profiled", True),
                           ("plain after", False)):
        runs[name] = capture_train_run(card, scene, tmp, name, profiled)
        launch[f"after {name}"] = launch_us()
    for name, (_, step_ms) in runs.items():
        print(f"  {name}: host ms per step "
              f"{[round(float(t), 3) for t in step_ms]} ({card})")
    print("  host us per launch of a one-element add_ (median of 5 x "
          "20,000, ending in a sync): " + ", ".join(
              f"{k} {v:.3f}" for k, v in launch.items()) + f" ({card})")
    start, num = JPEG_PROFILE
    after = slice(start + num, JPEG_STEPS)
    print("  steps {}-{} after the window, median ms per step: {}".format(
        start + num + 1, JPEG_STEPS, ", ".join(
            f"{name} {float(np.median(ms[after])):.3f}"
            for name, (_, ms) in runs.items())), flush=True)
    eval_one_image(card, runs["profiled"][0], tmp)


def eval_one_image(card, run: str, tmp: str) -> None:
    """`python -m rsn_torch.cli.eval --max-images 1` on a run (LPIPS with
    seeded weights): eval.json's five keys finite, K1 launched."""
    import numpy as np
    import torch

    from rsn_torch import lpips as lpips_lib
    from rsn_torch.cli import eval as eval_cli

    weights = os.path.join(tmp, "eval_lpips_vgg.pth")
    torch.save(lpips_lib.export_torch_state_dict(lpips_lib.LPIPS(
        torch.Generator().manual_seed(SEED))), weights)
    os.environ["RSN_LPIPS_WEIGHTS"] = weights
    try:
        text, launches = run_cli(eval_cli.main, [
            "--load-dir", run, "--max-images", "1"])
    finally:
        del os.environ["RSN_LPIPS_WEIGHTS"]
    print("\n".join("  " + ln for ln in text.splitlines()))
    with open(os.path.join(run, "eval.json")) as fh:
        res = json.load(fh)
    print(f"  eval: {res}; K1 {launches['field_forward_v3']} launches "
          f"({card})", flush=True)
    if sorted(res) != ["coarse_psnr", "fine_lpips", "fine_psnr",
                       "fine_ssim", "psnr"] or not all(
                           np.isfinite(v) for v in res.values()):
        raise RuntimeError(f"eval.json: {res}")
    if launches["field_forward_v3"] <= 0:
        raise RuntimeError("eval did not run K1")


TIFF_DIR = os.path.join(REPO, "tests", "golden", "tiff")


def load_writer(name: str, path: str):
    """A fixtures' numpy writer, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def best_of_3_ms(fn) -> float:
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        runs.append(time.perf_counter() - t0)
    return 1e3 * min(runs)


def tiff_decode_check(card, tmp: str):
    """Every committed fixture of tests/golden/tiff/ decoded through
    read_image to PIL's recorded digest; one 800x800 frame of each timed
    kind, written by that folder's numpy writer, decoded (ms per frame,
    host CPU, one thread, best of 3, warm) beside the native PNG decoder
    and the baseline JPEG decoder on the same frame."""
    import numpy as np

    from rsn_torch.data import native, png
    from rsn_torch.data.jpeg import read_image, read_jpeg

    writer = load_writer("tiff_writer",
                         os.path.join(TIFF_DIR, "write_fixtures.py"))
    jpeg_writer = load_writer("jpeg_kinds_writer", os.path.join(
        JPEG_KINDS_DIR, "write_fixtures.py"))
    with open(os.path.join(TIFF_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    for fname, want in sorted(recorded["files"].items()):
        got = writer.digest(*read_image(os.path.join(TIFF_DIR, fname)))
        if got != want:
            raise RuntimeError(f"tiff/{fname}: decoded to {got}, PIL's "
                               f"decode is {want}")
    print(f"  {len(recorded['files'])} TIFF fixtures == PIL "
          f"{recorded['pil']} / libtiff {recorded['libtiff']} / "
          f"libjpeg-turbo {recorded['libjpeg_turbo']}'s decode (mode, "
          f"shape, dtype, sha256) ({card})", flush=True)
    times = {}
    for name, (spp, bits, opts) in writer.TIMED_KINDS.items():
        px = writer.frame_samples(FRAME_RES, spp, bits)
        path = os.path.join(tmp, f"{name}.tif")
        with open(path, "wb") as fh:
            fh.write(writer.write_tiff(px, **opts))
        mode, arr = read_image(path)
        if mode != "RGB" or arr.shape != (FRAME_RES, FRAME_RES, 3):
            raise RuntimeError(f"{name}: {mode} {arr.shape}")
        if opts.get("compression") == 7:  # YCbCr converted: near px
            y, cb, cr = (px.astype(np.float64)[..., c] for c in range(3))
            rgb = np.stack([y + 1.402 * (cr - 128),
                            y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
                            y + 1.772 * (cb - 128)], -1)
            err = np.abs(arr - np.clip(rgb, 0, 255)).mean()
            if err > 3:
                raise RuntimeError(f"{name}: mean error {err:.3f}")
        elif not np.array_equal(arr, px if bits == 8 else px >> 8):
            raise RuntimeError(f"{name}: not the writer's samples")
        times[name] = (best_of_3_ms(lambda: read_image(path)),
                       os.path.getsize(path))
    px = writer.frame_samples(FRAME_RES, 3)
    png_path = os.path.join(tmp, "frame.png")
    png.write_png(png_path, px)
    jpeg_path = os.path.join(tmp, "frame.jpg")
    with open(jpeg_path, "wb") as fh:
        fh.write(jpeg_writer.write_jpeg(px, sampling=[(2, 2), (1, 1),
                                                      (1, 1)], quality=90))
    png_ms = best_of_3_ms(lambda: native.decode_png_batch(
        [png_path], FRAME_RES, FRAME_RES, num_threads=1))
    jpeg_ms = best_of_3_ms(lambda: read_jpeg(jpeg_path))
    print(f"  ms per {FRAME_RES}x{FRAME_RES} RGB frame (host CPU, one "
          f"thread, best of 3, warm): " + ", ".join(
              f"TIFF {k} {ms:.4f} ({size} bytes)"
              for k, (ms, size) in times.items())
          + f"; native PNG decoder {png_ms:.4f}, baseline JPEG (4:2:0, "
          f"quality 90) {jpeg_ms:.4f} ({card})", flush=True)
    return writer


def tiff_phase(card, tmp: str) -> None:
    """Phase 24: the TIFF decoder on this host, then a nerfstudio capture
    of five 800x800 TIFF frames (LZW, predictor 2, 8-bit RGB: phase 21's
    JPEG frames' pixels) through the train CLI and the eval CLI, each from
    zeroed launch counts."""
    import numpy as np

    from rsn_torch.data.blender import load_dataset
    from rsn_torch.data.jpeg import read_jpeg

    phase(f"phase 24: TIFF frames: the fixtures against PIL's digests, "
          f"{FRAME_RES}x{FRAME_RES} frames of each kind timed, then train "
          f"and eval on a nerfstudio capture of {FRAME_RES}x{FRAME_RES} "
          f"TIFFs")
    writer = tiff_decode_check(card, tmp)
    with open(os.path.join(JPEG_DIR, "digests.json")) as fh:
        jpegs = sorted(os.path.join(JPEG_DIR, f) for f in json.load(fh)[
            "files"] if f.startswith("frame_"))
    frames, pixels = [], []
    os.makedirs(os.path.join(tmp, "tiff_frames"))
    for path in jpegs:
        _, px = read_jpeg(path)
        out = os.path.join(tmp, "tiff_frames",
                           os.path.basename(path)[:-4] + ".tif")
        with open(out, "wb") as fh:
            fh.write(writer.write_tiff(px, photometric=2, compression=5,
                                       predictor=2, rows_per_strip=8))
        frames.append(out)
        pixels.append(px)
    scene = write_capture(frames, os.path.join(tmp, "tiff_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    want = np.stack(pixels).astype(np.float32) / 255.0
    if not all(any(np.array_equal(img, w) for w in want)
               for img in ds.images):
        raise RuntimeError("the TIFF capture's train split does not load "
                           "to its frames' pixels / 255")
    print(f"  load_nerfstudio: {ds.images.shape[0]} TIFF frames of "
          f"{ds.images.shape[2]}x{ds.images.shape[1]} in {load_s:.4f} s "
          f"(host clock; each == its frame's pixels / 255) ({card})")
    run, step_ms = capture_train_run(card, scene, tmp, "tiff", False)
    print(f"  tiff: host ms per step {[round(float(t), 3) for t in step_ms]}"
          f" ({card})", flush=True)
    eval_one_image(card, run, tmp)


WEBP_DIR = os.path.join(REPO, "tests", "golden", "webp")


def webp_decode_check(card, tmp: str):
    """Every committed fixture of tests/golden/webp/ decoded through
    read_image to PIL's recorded digest; the writer's 800x800 VP8L frame
    == its samples; ms per 800x800 frame (host CPU, one thread, best of 3,
    warm) of each kind beside the native PNG decoder and the baseline JPEG
    decoder on the same pixels -> the writer."""
    import numpy as np

    from rsn_torch.data import native, png
    from rsn_torch.data.jpeg import read_image, read_jpeg

    writer = load_writer("webp_writer",
                         os.path.join(WEBP_DIR, "write_fixtures.py"))
    jpeg_writer = load_writer("jpeg_kinds_writer", os.path.join(
        JPEG_KINDS_DIR, "write_fixtures.py"))
    with open(os.path.join(WEBP_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    for fname, want in sorted(recorded["files"].items()):
        got = writer.digest(*read_image(os.path.join(WEBP_DIR, fname)))
        if got != want:
            raise RuntimeError(f"webp/{fname}: decoded to {got}, PIL's "
                               f"decode is {want}")
    print(f"  {len(recorded['files'])} WebP fixtures == PIL "
          f"{recorded['pil']} / libwebp {recorded['libwebp']}'s decode "
          f"(mode, shape, dtype, sha256) ({card})", flush=True)
    lossy = os.path.join(WEBP_DIR, "frame_00000.webp")
    mode, px = read_image(lossy)
    if mode != "RGB" or px.shape != (FRAME_RES, FRAME_RES, 3):
        raise RuntimeError(f"frame_00000.webp: {mode} {px.shape}")
    t0 = time.perf_counter()
    data, samples = writer.timed_lossless(FRAME_RES)
    write_s = time.perf_counter() - t0
    lossless = os.path.join(tmp, "lossless.webp")
    with open(lossless, "wb") as fh:
        fh.write(data)
    mode, arr = read_image(lossless)
    if mode != "RGB" or not np.array_equal(arr, samples):
        raise RuntimeError("the writer's 800x800 VP8L frame does not decode "
                           "to its samples")
    with open(lossy, "rb") as fh:
        data, alpha = writer.timed_lossy_alpha(fh.read())
    with_alpha = os.path.join(tmp, "lossy_alpha.webp")
    with open(with_alpha, "wb") as fh:
        fh.write(data)
    mode, arr = read_image(with_alpha)
    if (mode != "RGBA" or not np.array_equal(arr[..., :3], px)
            or not np.array_equal(arr[..., 3], alpha)):
        raise RuntimeError("the lossy frame with ALPH is not the lossy "
                           "frame's pixels and the writer's alpha")
    print(f"  the writer's {FRAME_RES}x{FRAME_RES} VP8L frame (subtract "
          f"green, predictor, cross-colour, colour cache, LZ77; written in "
          f"{write_s:.3f} s) == its samples; the lossy frame + ALPH == its "
          f"pixels and alpha ({card})", flush=True)
    times = {k: (best_of_3_ms(lambda p=p: read_image(p)), os.path.getsize(p))
             for k, p in (("lossy q90", lossy), ("lossless", lossless),
                          ("lossy + ALPH", with_alpha))}
    png_path = os.path.join(tmp, "frame.png")
    png.write_png(png_path, px)
    jpeg_path = os.path.join(tmp, "frame.jpg")
    with open(jpeg_path, "wb") as fh:
        fh.write(jpeg_writer.write_jpeg(px, sampling=[(2, 2), (1, 1),
                                                      (1, 1)], quality=90))
    png_ms = best_of_3_ms(lambda: native.decode_png_batch(
        [png_path], FRAME_RES, FRAME_RES, num_threads=1))
    jpeg_ms = best_of_3_ms(lambda: read_jpeg(jpeg_path))
    print(f"  ms per {FRAME_RES}x{FRAME_RES} frame (host CPU, one thread, "
          f"best of 3, warm): " + ", ".join(
              f"WebP {k} {ms:.4f} ({size} bytes)"
              for k, (ms, size) in times.items())
          + f"; native PNG decoder {png_ms:.4f}, baseline JPEG (4:2:0, "
          f"quality 90) {jpeg_ms:.4f} on the lossy frame's pixels ({card})",
          flush=True)
    return writer


def webp_phase(card, tmp: str) -> None:
    """Phase 25: the WebP decoder on this host, then a nerfstudio capture
    of the five committed 800x800 lossy WebP frames through load_dataset
    and the train CLI (graphed steps), from zeroed launch counts."""
    import shutil

    import numpy as np

    from rsn_torch.data.blender import load_dataset
    from rsn_torch.data.jpeg import read_image

    phase(f"phase 25: WebP frames: the fixtures against PIL's digests, "
          f"{FRAME_RES}x{FRAME_RES} frames of each kind timed, then train "
          f"on a nerfstudio capture of {FRAME_RES}x{FRAME_RES} WebPs")
    writer = webp_decode_check(card, tmp)
    with open(os.path.join(WEBP_DIR, "digests.json")) as fh:
        recorded = json.load(fh)["files"]
    frames, pixels = [], []
    os.makedirs(os.path.join(tmp, "webp_frames"))
    for name in writer.FRAMES:
        src = os.path.join(WEBP_DIR, writer.fixture_name(name))
        out = os.path.join(tmp, "webp_frames", writer.fixture_name(name))
        shutil.copyfile(src, out)
        mode, px = read_image(out)
        if writer.digest(mode, px) != recorded[writer.fixture_name(name)]:
            raise RuntimeError(f"{name}: not PIL's decode")
        frames.append(out)
        pixels.append(px)
    scene = write_capture(frames, os.path.join(tmp, "webp_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    want = np.stack(pixels).astype(np.float32) / 255.0
    if not all(any(np.array_equal(img, w) for w in want)
               for img in ds.images):
        raise RuntimeError("the WebP capture's train split does not load "
                           "to its frames' pixels / 255")
    print(f"  load_nerfstudio: {ds.images.shape[0]} WebP frames of "
          f"{ds.images.shape[2]}x{ds.images.shape[1]} in {load_s:.4f} s "
          f"(host clock; each == its frame's pixels / 255, PIL's digests) "
          f"({card})", flush=True)
    _, step_ms = capture_train_run(card, scene, tmp, "webp", False)
    print(f"  webp: host ms per step {[round(float(t), 3) for t in step_ms]}"
          f" ({card})", flush=True)


RASTER_DIRS = {k: os.path.join(REPO, "tests", "golden", k)
               for k in ("bmp", "ppm", "gif", "tga")}


def raster_decode_check(card, tmp: str, px):
    """Every committed fixture of tests/golden/{bmp,ppm,gif,tga}/ decoded
    through read_image to PIL's recorded digest, PIL's refusals refused;
    the 800x800 pixels `px` as each timed kind, decoded back to its
    pixels, ms per frame (host CPU, one thread, best of 3, warm) beside
    the native PNG decoder and the baseline JPEG decoder on the same
    pixels -> the four writers."""
    import numpy as np

    from rsn_torch.data import native, png
    from rsn_torch.data.jpeg import read_image, read_jpeg

    writers = {k: load_writer(f"{k}_writer", os.path.join(d,
                                                          "write_fixtures.py"))
               for k, d in RASTER_DIRS.items()}
    for k, d in RASTER_DIRS.items():
        with open(os.path.join(d, "digests.json")) as fh:
            recorded = json.load(fh)
        for fname, want in sorted(recorded["files"].items()):
            got = writers[k].digest(*read_image(os.path.join(d, fname)))
            if got != want:
                raise RuntimeError(f"{k}/{fname}: decoded to {got}, PIL's "
                                   f"decode is {want}")
        for fname in sorted(recorded["refused"]):
            try:
                read_image(os.path.join(d, fname))
            except ValueError:
                continue
            raise RuntimeError(f"{k}/{fname}: PIL refuses it "
                               f"({recorded['refused'][fname]}), the port "
                               "decodes it")
        print(f"  {len(recorded['files'])} {k.upper()} fixtures == PIL "
              f"{recorded['pil']}'s decode (mode, shape, dtype, sha256), "
              f"{len(recorded['refused'])} it refuses refused ({card})",
              flush=True)
    gray = px[..., 1]
    b, p, g, t = (writers[k] for k in ("bmp", "ppm", "gif", "tga"))
    kinds = {  # name -> (file bytes, PIL's mode, the array it holds)
        "BMP 24-bit": (b.write_24bit(px), "RGB", px),
        "BMP RLE8": (b.write_rle8_gray(gray), "L", gray),
        "PPM P6": (p.write_p6(px), "RGB", px),
        "PGM 16-bit": (p.write_p5_16bit(gray.astype(np.uint16) * 257), "I",
                       gray.astype(np.int32) * 257),
        "GIF": (g.write_gray(gray), "L", gray),
        "TGA RLE": (t.write_rle24(px), "RGB", px)}
    times = {}
    for name, (data, mode, want) in kinds.items():
        path = os.path.join(tmp, name.replace(" ", "_"))
        with open(path, "wb") as fh:
            fh.write(data)
        got_mode, got = read_image(path)
        if got_mode != mode or not np.array_equal(got, want):
            raise RuntimeError(f"{name}: not its pixels ({got_mode})")
        times[name] = (best_of_3_ms(lambda p=path: read_image(p)), len(data))
    png_path = os.path.join(tmp, "frame.png")
    png.write_png(png_path, px)
    jpeg_writer = load_writer("jpeg_kinds_writer", os.path.join(
        JPEG_KINDS_DIR, "write_fixtures.py"))
    jpeg_path = os.path.join(tmp, "frame.jpg")
    with open(jpeg_path, "wb") as fh:
        fh.write(jpeg_writer.write_jpeg(px, sampling=[(2, 2), (1, 1),
                                                      (1, 1)], quality=90))
    png_ms = best_of_3_ms(lambda: native.decode_png_batch(
        [png_path], FRAME_RES, FRAME_RES, num_threads=1))
    jpeg_ms = best_of_3_ms(lambda: read_jpeg(jpeg_path))
    print(f"  ms per {FRAME_RES}x{FRAME_RES} frame (host CPU, one thread, "
          f"best of 3, warm): " + ", ".join(
              f"{k} {ms:.4f} ({size} bytes)" for k, (ms, size) in
              times.items())
          + f"; native PNG decoder {png_ms:.4f}, baseline JPEG (4:2:0, "
          f"quality 90) {jpeg_ms:.4f} on the same pixels ({card})",
          flush=True)
    return writers


def raster_phase(card, tmp: str) -> None:
    """Phase 26: the BMP, PPM, GIF and TGA readers on this host, then a
    nerfstudio capture of phase 21's five 800x800 frames as a BMP, a PPM,
    a TGA, a GIF and an RLE8 BMP through load_dataset and the train CLI
    (graphed steps), from zeroed launch counts."""
    import numpy as np

    from rsn_torch.data.blender import load_dataset
    from rsn_torch.data.jpeg import read_image, read_jpeg

    start = time.perf_counter()
    phase(f"phase 26: BMP, PPM, GIF and TGA frames: the fixtures against "
          f"PIL's digests, {FRAME_RES}x{FRAME_RES} frames of each kind "
          f"timed, then train on a nerfstudio capture of all four formats")
    with open(os.path.join(JPEG_DIR, "digests.json")) as fh:
        jpegs = sorted(os.path.join(JPEG_DIR, f) for f in json.load(fh)[
            "files"] if f.startswith("frame_"))
    pixels = [read_jpeg(path)[1] for path in jpegs]
    w = raster_decode_check(card, tmp, pixels[0])
    kinds = [(".bmp", w["bmp"].write_24bit, False),
             (".ppm", w["ppm"].write_p6, False),
             (".tga", w["tga"].write_rle24, False),
             (".gif", w["gif"].write_gray, True),
             (".bmp", w["bmp"].write_rle8_gray, True)]
    frames, want = [], []
    os.makedirs(os.path.join(tmp, "raster_frames"))
    for path, px, (ext, write, gray) in zip(jpegs, pixels, kinds):
        out = os.path.join(tmp, "raster_frames",
                           os.path.basename(path)[:-4] + ext)
        with open(out, "wb") as fh:
            fh.write(write(px[..., 1] if gray else px))
        mode, arr = read_image(out)
        if mode != ("L" if gray else "RGB"):
            raise RuntimeError(f"{out}: mode {mode}")
        rgb = np.repeat(arr[..., None], 3, -1) if gray else arr
        want.append(rgb.astype(np.float32) / 255.0)
        frames.append(out)
    scene = write_capture(frames, os.path.join(tmp, "raster_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    if not all(any(np.array_equal(img, x) for x in want)
               for img in ds.images):
        raise RuntimeError("the capture's train split does not load to its "
                           "frames' pixels / 255")
    print(f"  load_nerfstudio: the train split's {ds.images.shape[0]} of the "
          f"five frames (BMP, PPM, TGA, GIF, RLE8 BMP) of "
          f"{ds.images.shape[2]}x{ds.images.shape[1]} in {load_s:.4f} s "
          f"(host clock; each == its frame's pixels / 255) ({card})",
          flush=True)
    _, step_ms = capture_train_run(card, scene, tmp, "raster", False)
    print(f"  raster: host ms per step "
          f"{[round(float(t), 3) for t in step_ms]} ({card})")
    print(f"  phase 26: {time.perf_counter() - start:.1f} s ({card})",
          flush=True)


JPEG2000_DIR = os.path.join(REPO, "tests", "golden", "jpeg2000")


def jpeg2000_decode_check(card, tmp: str):
    """Every committed fixture of tests/golden/jpeg2000/ decoded through
    read_image to PIL's recorded digest, PIL's refusals refused; its five
    800x800 frames timed (host CPU, one thread, best of 3, warm) beside
    the native PNG decoder and the baseline JPEG decoder on the same
    8-bit pixels -> [(frame path, its pixels / 255 as load_dataset gives
    them)]."""
    import numpy as np

    from rsn_torch.data import native, png
    from rsn_torch.data.jpeg import read_image, read_jpeg

    writer = load_writer("jpeg2000_writer",
                         os.path.join(JPEG2000_DIR, "write_fixtures.py"))
    jpeg_writer = load_writer("jpeg_kinds_writer", os.path.join(
        JPEG_KINDS_DIR, "write_fixtures.py"))
    with open(os.path.join(JPEG2000_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    for fname, want in sorted(recorded["files"].items()):
        got = writer.digest(*read_image(os.path.join(JPEG2000_DIR, fname)))
        if got != want:
            raise RuntimeError(f"jpeg2000/{fname}: decoded to {got}, PIL's "
                               f"decode is {want}")
    for fname in sorted(recorded["refused"]):
        try:
            read_image(os.path.join(JPEG2000_DIR, fname))
        except ValueError:
            continue
        raise RuntimeError(f"jpeg2000/{fname}: PIL refuses it "
                           f"({recorded['refused'][fname]}), the port "
                           "decodes it")
    print(f"  {len(recorded['files'])} JPEG 2000 fixtures == PIL "
          f"{recorded['pil']}'s decode (mode, shape, dtype, sha256), "
          f"{len(recorded['refused'])} it refuses refused ({card})",
          flush=True)
    frames = []
    for name in writer.FRAMES:
        path = os.path.join(JPEG2000_DIR, name)
        mode, arr = read_image(path)
        px8 = (arr >> 8).astype(np.uint8) if mode == "I;16" else arr
        png_path = os.path.join(tmp, name + ".png")
        png.write_png(png_path, px8)
        jpeg_path = os.path.join(tmp, name + ".jpg")
        with open(jpeg_path, "wb") as fh:
            if px8.ndim == 2:
                fh.write(jpeg_writer.write_jpeg(px8[..., None], quality=90))
            else:
                fh.write(jpeg_writer.write_jpeg(
                    px8, sampling=[(2, 2), (1, 1), (1, 1)], quality=90))
        ms = best_of_3_ms(lambda p=path: read_image(p))
        png_ms = best_of_3_ms(lambda: native.decode_png_batch(
            [png_path], FRAME_RES, FRAME_RES, num_threads=1))
        jpeg_ms = best_of_3_ms(lambda: read_jpeg(jpeg_path))
        print(f"  {name} ({mode}, {os.path.getsize(path)} bytes): "
              f"{ms:.4f} ms per {FRAME_RES}x{FRAME_RES} frame (host CPU, "
              f"one thread, best of 3, warm); native PNG decoder "
              f"{png_ms:.4f}, baseline JPEG (quality 90) {jpeg_ms:.4f} on "
              f"the same 8-bit pixels ({card})", flush=True)
        rgb = arr.astype(np.float32) / 255.0
        frames.append((path, np.repeat(rgb[..., None], 3, -1)
                       if rgb.ndim == 2 else rgb))
    return frames


def jpeg2000_phase(card, tmp: str) -> None:
    """Phase 27: the JPEG 2000 reader on this host, then a nerfstudio
    capture of the five 800x800 JPEG 2000 frames through load_dataset and
    the train CLI (graphed steps), from zeroed launch counts."""
    import numpy as np

    from rsn_torch.data.blender import load_dataset

    start = time.perf_counter()
    phase(f"phase 27: JPEG 2000 frames: the fixtures against PIL's digests, "
          f"the five {FRAME_RES}x{FRAME_RES} frames timed, then train on a "
          f"nerfstudio capture of them")
    frames = jpeg2000_decode_check(card, tmp)
    scene = write_capture([p for p, _ in frames],
                          os.path.join(tmp, "jpeg2000_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    if not all(any(np.array_equal(img, x) for _, x in frames)
               for img in ds.images):
        raise RuntimeError("the capture's train split does not load to its "
                           "frames' pixels / 255")
    print(f"  load_nerfstudio: the train split's {ds.images.shape[0]} of the "
          f"five JPEG 2000 frames of {ds.images.shape[2]}x"
          f"{ds.images.shape[1]} in {load_s:.4f} s (host clock; each == its "
          f"frame's pixels / 255) ({card})", flush=True)
    _, step_ms = capture_train_run(card, scene, tmp, "jpeg2000", False)
    print(f"  jpeg2000: host ms per step "
          f"{[round(float(t), 3) for t in step_ms]} ({card})")
    print(f"  phase 27: {time.perf_counter() - start:.1f} s ({card})",
          flush=True)


AVIF_DIR = os.path.join(REPO, "tests", "golden", "avif")


def avif_decode_check(card, tmp: str):
    """Every committed fixture of tests/golden/avif/ decoded through
    read_image to PIL's recorded digest, the kinds not ported refused
    (NotImplementedError), PIL's refusals refused (ValueError, or no
    plugin where libavif's parse declines the file); its five 800x800
    frames timed (host CPU, one thread, best of 3, warm) beside the
    native PNG decoder and the baseline JPEG decoder on the same pixels
    -> [(frame path, its pixels / 255 as load_dataset gives them)]."""
    import numpy as np

    from rsn_torch.data import native, png
    from rsn_torch.data.jpeg import read_image, read_jpeg

    writer = load_writer("avif_writer",
                         os.path.join(AVIF_DIR, "write_fixtures.py"))
    jpeg_writer = load_writer("jpeg_kinds_writer", os.path.join(
        JPEG_KINDS_DIR, "write_fixtures.py"))
    with open(os.path.join(AVIF_DIR, "digests.json")) as fh:
        recorded = json.load(fh)
    decoded = unported = 0
    for fname, want in sorted(recorded["files"].items()):
        path = os.path.join(AVIF_DIR, fname)
        if fname in writer.UNPORTED_CASES:
            try:
                read_image(path)
            except NotImplementedError as e:
                if "ROADMAP Queue 1" not in str(e):
                    raise
                unported += 1
                continue
            raise RuntimeError(f"avif/{fname}: a kind the port does not "
                               "decode yet, decoded")
        got = writer.digest(*read_image(path))
        if got != want:
            raise RuntimeError(f"avif/{fname}: decoded to {got}, PIL's "
                               f"decode is {want}")
        decoded += 1
    for fname, err in sorted(recorded["refused"].items()):
        declined = err.startswith("UnidentifiedImageError")
        try:
            read_image(os.path.join(AVIF_DIR, fname))
        except NotImplementedError as e:
            if declined and "not a file any" in str(e):
                continue
            raise
        except ValueError:
            if not declined:
                continue
            raise
        raise RuntimeError(f"avif/{fname}: PIL refuses it ({err}), the "
                           "port decodes it")
    print(f"  {decoded} AVIF fixtures == PIL {recorded['pil']}'s decode "
          f"(mode, shape, dtype, sha256), {unported} kinds not ported "
          f"refused, {len(recorded['refused'])} PIL refuses refused "
          f"({card})", flush=True)
    frames = []
    for name in writer.FRAMES:
        path = os.path.join(AVIF_DIR, name)
        mode, arr = read_image(path)
        png_path = os.path.join(tmp, name + ".png")
        png.write_png(png_path, arr)
        jpeg_path = os.path.join(tmp, name + ".jpg")
        with open(jpeg_path, "wb") as fh:
            fh.write(jpeg_writer.write_jpeg(
                np.ascontiguousarray(arr[..., :3]),
                sampling=[(2, 2), (1, 1), (1, 1)], quality=90))
        ms = best_of_3_ms(lambda p=path: read_image(p))
        png_ms = best_of_3_ms(lambda: native.decode_png_batch(
            [png_path], FRAME_RES, FRAME_RES, num_threads=1))
        jpeg_ms = best_of_3_ms(lambda: read_jpeg(jpeg_path))
        print(f"  {name} ({mode}, {os.path.getsize(path)} bytes): "
              f"{ms:.4f} ms per {FRAME_RES}x{FRAME_RES} frame (host CPU, "
              f"one thread, best of 3, warm); native PNG decoder "
              f"{png_ms:.4f}, baseline JPEG (quality 90) {jpeg_ms:.4f} on "
              f"the same pixels ({card})", flush=True)
        rgb = arr.astype(np.float32) / 255.0
        if rgb.shape[-1] == 4:  # blended to white, as load_dataset blends
            rgb = rgb[..., :3] * rgb[..., 3:] + (1.0 - rgb[..., 3:])
        frames.append((path, rgb))
    return frames


def avif_phase(card, tmp: str) -> None:
    """Phase 28: the AVIF reader on this host, then a nerfstudio capture
    of the five 800x800 AVIF frames through load_dataset and the train CLI
    (graphed steps), from zeroed launch counts."""
    import numpy as np

    from rsn_torch.data.blender import load_dataset

    start = time.perf_counter()
    phase(f"phase 28: AVIF frames: the fixtures against PIL's digests, the "
          f"five {FRAME_RES}x{FRAME_RES} frames timed, then train on a "
          f"nerfstudio capture of them")
    frames = avif_decode_check(card, tmp)
    scene = write_capture([p for p, _ in frames],
                          os.path.join(tmp, "avif_capture"))
    t0 = time.perf_counter()
    ds = load_dataset("nerfstudio", scene, "train")
    load_s = time.perf_counter() - t0
    if not all(any(np.array_equal(img, x) for _, x in frames)
               for img in ds.images):
        raise RuntimeError("the capture's train split does not load to its "
                           "frames' pixels / 255")
    print(f"  load_nerfstudio: the train split's {ds.images.shape[0]} of the "
          f"five AVIF frames of {ds.images.shape[2]}x{ds.images.shape[1]} "
          f"in {load_s:.4f} s (host clock; each == its frame's pixels / "
          f"255, RGBA blended to white) ({card})", flush=True)
    _, step_ms = capture_train_run(card, scene, tmp, "avif", False)
    print(f"  avif: host ms per step "
          f"{[round(float(t), 3) for t in step_ms]} ({card})")
    print(f"  phase 28: {time.perf_counter() - start:.1f} s ({card})",
          flush=True)


def io_lines(fn):
    """fn()'s printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def png_bytes_pixels(data: bytes):
    """The pixels of a PNG in memory, through the port's read_png."""
    from rsn_torch.data.png import read_png

    with tempfile.NamedTemporaryFile(suffix=".png") as fh:
        fh.write(data)
        fh.flush()
        return read_png(fh.name)[1]


RENDER_KERNELS = ("field_forward_v3", "field_forward_density")
TRAIN_KERNELS = ("field_forward_v6", "field_backward_v6",
                 "field_backward_v5", "train_blob")
KERNEL_ROWS = (
    ("field_forward_v3", "field_forward.cu",
     "rsn/kernels/field_pallas.py:512"),
    ("field_forward_density", "field_forward.cu",
     "rsn/kernels/field_pallas.py:626"),
    ("field_forward_v6", "field_train.cu",
     "rsn/kernels/field_pallas.py:794"),
    ("train_blob", "field_train.cu", "rsn/kernels/field_pallas.py:794"),
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
    ("field_backward_v4_wgrad", "wgrad_sm90.cuh",
     "rsn/kernels/field_train.py:427"),
    ("field_forward_v5", "field_train.cu",
     "rsn/kernels/field_pallas.py:945"),
    ("field_forward_v2", "field_forward.cu",
     "rsn/kernels/field_pallas.py:182"),
    ("field_forward", "field_forward.cu",
     "rsn/kernels/field_pallas.py:217"),
    ("field_backward_v3", "field_train.cu",
     "rsn/kernels/field_train.py:353"),
    ("field_backward_v3_wgrad", "wgrad_sm90.cuh",
     "rsn/kernels/field_train.py:353"),
    ("field_backward_v3_sum", "field_train.cu",
     "rsn/kernels/field_train.py:353"),
    ("field_forward_v3u", "experiments.cu", "tools/exp_interleave.py:161"),
    ("field_forward_v3i", "experiments.cu", "tools/exp_interleave.py:77"),
    ("field_forward_v3L", "experiments.cu", "tools/exp_interleave2.py:124"),
    ("field_forward_v3F", "experiments.cu", "tools/exp_interleave2.py:124"),
) + tuple((f"cheap_sin_{m}", "experiments.cu", "tools/exp_cheap_sin.py:82")
          for m in ("copy", "exact", "poly", "exp", "exp2", "exp2_ldexp",
                    "poly_bf16", "cos_poly")) + (
    ("field_backward_whole", "field_train.cu", "tools/exp_bwd_whole.py:76"),
    ("field_backward_whole_wgrad", "wgrad_sm90.cuh",
     "tools/exp_bwd_whole.py:76"),
) + tuple((f"bwd_ablate_{m}", "experiments_bwd.cu",
           "tools/exp_bwd_ablate.py:191")
          for m in ("full_wgrad", "full", "no_ipe_bwd", "recompute",
                    "spill")) + (
    ("run_noipe", "experiments_bwd.cu", "tools/exp_bwd_noipe.py:171"),
    ("bwd_unfolded_wgrad", "wgrad_sm90.cuh", "tools/exp_bwd_ablate.py:191"),
)


def mma_probe(card) -> None:
    """K1's and K2's wgmma against trunk()'s mma.sync: one 64 x 256 x 256
    bf16 layer on seeded inputs through both instructions; the fp32 sums
    must agree bit for bit (the premise of K2 == K1 == K3 on the density
    column), and both must be the product (against float64)."""
    import numpy as np
    import torch

    from rsn_torch.kernels import trunk_sm90 as ts

    for seed in range(4):
        rng = np.random.default_rng(SEED + seed)
        a = rng.standard_normal((64, 256))
        w = rng.standard_normal((256, 256)) * 0.06
        if seed == 3:  # exponents over 2^-12..2^12: the sums round
            a = a * np.exp2(rng.integers(-12, 12, a.shape))
            w = w * np.exp2(rng.integers(-12, 12, w.shape))
        a = torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).cuda()
        w = torch.tensor(w, dtype=torch.float32).to(torch.bfloat16).cuda()
        d_wgmma, d_mma = ts.mma_probe(a, w)
        torch.cuda.synchronize()
        same = int((d_wgmma.view(torch.int32) == d_mma.view(torch.int32))
                   .sum())
        ref = a.double() @ w.double()
        scale = float((a.double().abs() @ w.double().abs()).max())
        err = float((d_wgmma.double() - ref).abs().max()) / scale
        print(f"  probe seed {seed}: wgmma m64n256k16 == mma.sync m16n8k16 "
              f"on {same} of {d_mma.numel()} fp32 sums; max |wgmma - "
              f"float64| {err:.3g} of the largest |a| @ |w| ({card})",
              flush=True)
        if same != d_mma.numel() or err > 1e-5:
            raise RuntimeError("the wgmma / mma.sync probe disagrees")


def kernel_registers(source: str, names, no_spill: bool = False) -> None:
    """The registers and spills of `source`'s kernels {mangled name part:
    label} from the build's ptxas output; with no_spill, raises if one
    spills."""
    from rsn_torch.kernels.build import build_log

    seen, cur = {}, None
    for line in build_log(source).splitlines():
        if "Compiling entry function" in line:
            cur = next((v for k, v in names.items() if k in line), None)
        elif cur and ("spill" in line or "registers" in line):
            seen.setdefault(cur, []).append(line.split(":")[-1].strip())
    if not seen:
        print(f"  {', '.join(names.values())}: no ptxas output (the library "
              f"was built before this run)")
    for name, lines in seen.items():
        print(f"  {name}: {'; '.join(lines)}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", " ".join(lines))
        if no_spill and spill and (int(spill.group(1)) or
                                   int(spill.group(2))):
            raise RuntimeError(f"{name} spills registers")
    sys.stdout.flush()


def local_memory_ops(source: str, names) -> None:
    """Prints the local-memory loads and stores (LDL, STL: register
    spills) in the SASS (cuobjdump) of `source`'s kernels {mangled name
    part: label}: in all, and in the producer warpgroup's branch, laid out
    from its setmaxnreg.dec (USETMAXREG.DEALLOC) to the next EXIT, with
    that span's MUFU.EX2 count (the IPE's exp2, where K10's IPE warps run
    there at 40 registers)."""
    from rsn_torch.kernels.build import sass

    funcs, cur = {}, None
    for line in sass(source).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = next((v for k, v in names.items() if k in m.group(1)), None)
            if cur:
                funcs[cur] = []
        elif cur:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if ins:
                funcs[cur].append(ins.group(1))
    for name, ins in funcs.items():
        def count(ops, lo=0, hi=len(ins)):
            return [sum(1 for i in ins[lo:hi] if re.search(rf"(^|\s){k}\b", i))
                    for k in ops]
        ldl, stl = count(("LDL", "STL"))
        span = ""
        dec = next((j for j, i in enumerate(ins)
                    if "SETMAXREG" in i and "DEALLOC" in i), None)
        if dec is not None:
            end = next((j for j in range(dec, len(ins))
                        if re.search(r"(^|\s)EXIT\b", ins[j])), len(ins))
            pl, ps, ex2 = count(("LDL", "STL", r"MUFU\.EX2"), dec, end)
            span = (f"; the producer warpgroup's branch ({end - dec} "
                    f"instructions, {ex2} MUFU.EX2): {pl} LDL, {ps} STL")
        print(f"  SASS {name}: {ldl} LDL, {stl} STL{span}")
    sys.stdout.flush()


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


def ulps_of_max(got, ref) -> float:
    """max |got - ref| in ulps of ref's largest magnitude (fp32: 2^-23 of
    its binade)."""
    m = float(ref.abs().max())
    d = float((got.float() - ref.float()).abs().max())
    return d / 2.0 ** (math.floor(math.log2(m)) - 23) if m > 0 else d


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (one tensor)."""
    scale = max(float(ref.float().abs().max()), 1e-6)
    return float((got.float() - ref.float()).abs().max()) / scale


def capture_train_inputs(trainer, step: int):
    """Run one train step at `step` and record every training kernel
    call's inputs: -> {"fwd": [...], "bwd5": [...], "bwd6": [...]} in
    call order (forward passes 1-4, then the backward of passes 4, 3
    (K4) and 2, 1 (K5)), "blob": the forwards' weight blob (one for the
    step) and "pack": the fp32 operands it was packed from (w0..w7,
    w_hc, with their strides)."""
    import torch

    from rsn_torch.kernels import field_train as ft

    calls = {"fwd": [], "bwd5": [], "bwd6": [], "blobs": []}
    real = (ft.field_forward_v6, ft.field_backward_v5, ft.field_backward_v6,
            ft.train_blob)

    def fwd(packed, mc, g, S, want_normals=False, spill_x=False, blob=None):
        calls["fwd"].append((tuple(packed), mc.clone(), g.clone(), S,
                             want_normals, spill_x))
        calls["blobs"].append(blob)
        return real[0](packed, mc, g, S, want_normals, spill_x, blob=blob)

    def pack(ws, w_hc):  # clones keep the views' strides
        calls["pack"] = [w.detach().clone() for w in list(ws) + [w_hc]]
        return real[3](ws, w_hc)

    def bwd5(packed, mc, g, acts, d_out, f_out, S):
        calls["bwd5"].append((tuple(packed), mc.clone(), g.clone(),
                              acts.clone(), d_out.clone(), f_out.clone(), S))
        return real[1](packed, mc, g, acts, d_out, f_out, S)

    def bwd6(packed, g, xacts, d_out, f_out, S):
        calls["bwd6"].append((tuple(packed), g.clone(), xacts.clone(),
                              d_out.clone(), f_out.clone(), S))
        return real[2](packed, g, xacts, d_out, f_out, S)

    (ft.field_forward_v6, ft.field_backward_v5, ft.field_backward_v6,
     ft.train_blob) = (fwd, bwd5, bwd6, pack)
    try:
        trainer.step = step
        trainer.train_step()
    finally:
        (ft.field_forward_v6, ft.field_backward_v5, ft.field_backward_v6,
         ft.train_blob) = real
    torch.cuda.synchronize()
    got = tuple(len(calls[k]) for k in ("fwd", "bwd5", "bwd6"))
    if got != (4, 2, 2):
        raise RuntimeError(f"expected 4 + 2 + 2 training kernel calls, "
                           f"got {got}")
    calls["blob"] = one_blob(calls.pop("blobs"))
    return calls


def one_blob(blobs):
    """The weight blob that a step's forwards shared (one pack a step)."""
    if blobs[0] is None or any(b is not blobs[0] for b in blobs):
        raise RuntimeError("the step's forwards did not share one blob")
    return blobs[0]


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


def check_train_kernels(calls, card, no_spill):
    """Phase 6's comparisons and times -> per-kernel results.  no_spill:
    the build of field_train.cu with RSN_ABLATE_NO_SPILL (phase 2)."""
    import torch

    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels.build import load_library

    results = {k: {"err": 0.0} for k in TRAIN_KERNELS}
    r = results["field_forward_v6"]
    blob = calls["blob"]
    check_train_blob(calls["pack"], blob, results["train_blob"], card)
    for p, (packed, mc, g, S, wn, sx) in enumerate(calls["fwd"], start=1):
        out, acts = ft.field_forward_v6(packed, mc, g, S, wn, sx, blob=blob)
        ref, ref_acts = ft.field_forward_v6_plain(packed, mc, g, S, wn, sx)
        other = (ft.field_forward_v4 if wn else ft.field_forward_v3_train)(
            packed, mc, g, S, blob=blob)
        torch.cuda.synchronize()
        if not torch.equal(out, other):
            raise RuntimeError(f"K3 pass {p} differs from K7 / K1 at the "
                               f"train width")
        print(f"  K3 pass {p} == {'K7' if wn else 'K1 at the train width'} "
              f"on the same inputs, bit for bit")
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
            if key == "bwd6":  # K4 on the same spill, the pass's mean_cov
                packed, g, xacts, d_out, f_out, S = args
                mc = calls["fwd"][p - 1][1]
                k4 = ft.field_backward_v5(
                    packed, mc, g, xacts[:, :ft.ACTS_COLS].contiguous(),
                    d_out, f_out, S)
                if not same_grads((k4[0],) + got, k4):
                    raise RuntimeError(f"K5 pass {p} differs from K4 on the "
                                       f"same spill")
                print(f"  K5 pass {p} == K4 on the same spill (dg, all 20 "
                      f"gradients), bit for bit")

    # times and bounds: K3 on passes 2 and 4 (pass 2 also without its
    # spill: the ablation's build, in turns), K5 on pass 2, K4 on pass 4
    w_bytes = nbytes(*calls["fwd"][0][0][:20])
    packed, mc, g, S, wn, sx = calls["fwd"][1]
    full = load_library("field_train.cu")
    turns = [cuda_ms(lambda: ft.launch_field_forward_v6(
        lib, packed, mc, g, S, wn, sx, blob))
        for lib in (full, no_spill, no_spill, full)]
    spill = (turns[0] + turns[3] - turns[1] - turns[2]) / 2
    print(f"  K3 pass 2's spill alone ({mc.shape[0]} rows, {ft.XACTS_COLS} "
          f"bf16 columns): {spill:.4f} ms = K3 {turns[0]:.4f} / "
          f"{turns[3]:.4f} ms less K3 without its stores "
          f"(RSN_ABLATE_NO_SPILL) {turns[1]:.4f} / {turns[2]:.4f} ms (in "
          f"turns; median of 10; {card})", flush=True)
    for p in (2, 4):
        packed, mc, g, S, wn, sx = calls["fwd"][p - 1]
        n = mc.shape[0]
        k = cuda_ms(lambda: ft.field_forward_v6(packed, mc, g, S, wn, sx,
                                                blob=blob))
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
        ka, kb, plan = kernels_a_and_b(name, args)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res
        # the first design: one fp32 slice of the 20 gradients per block,
        # K5 at two blocks per SM
        per_sm = 2 if key == "bwd6" else 1
        first = -(-g.shape[0] // ft._per_block(
            g.shape[0], per_sm * ft._sm_count(g.device))) * ft.PACK_FLOATS * 4
        pl = cuda_ms(lambda: plain(*args))
        ins = nbytes(*[a for a in args[1:] if isinstance(a, torch.Tensor)])
        outs = g.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + (
            n * 16 * 4 if key == "bwd5" else 0)
        b, by = bound(FLOPS[name] * n, ins + w_bytes + outs)
        tag = "K4" if key == "bwd5" else "K5"
        print(f"  {tag} pass {p}: {n} rows, kernel {k:.4f} ms (kernel A "
              f"alone {ka:.4f} ms, kernel B alone {kb:.4f} ms over "
              f"{len(plan.chunks)} chunks of {plan.blocks} blocks x up to "
              f"{ft.TILES_PER_CHUNK} tiles, P = {plan.slices}), plain "
              f"{pl:.4f} ms, bound {b:.4f} ms ({by}; median of 10; "
              f"{card}); scratch per call {plan.scratch_bytes()} bytes (the "
              f"first design's slices: {first}), the peak of one call above "
              f"what was allocated before it {peak} bytes", flush=True)
        results[name].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    return results


def check_train_blob(pack, blob, result, card) -> None:
    """The forwards' weight blob: the step's equals one pack launch on the
    step's fp32 operands and the plain trunk_sm90.pack_train_blob on them,
    bit for bit; its time beside the plain version's and its bound (the
    operands read once, the blob written once)."""
    import torch

    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels import trunk_sm90 as ts

    ws, w_hc = pack[:8], pack[8]
    got = ft.train_blob(ws, w_hc)
    ref = ts.pack_train_blob(ws, w_hc)
    torch.cuda.synchronize()
    if not (torch.equal(got, blob) and torch.equal(got, ref)):
        raise RuntimeError("the train blob differs from its plain version")
    k = cuda_ms(lambda: ft.train_blob(ws, w_hc))
    pl = cuda_ms(lambda: ts.pack_train_blob(ws, w_hc))
    b, by = bound(0.0, nbytes(*pack) + nbytes(blob))
    print(f"  the train blob ({nbytes(blob)} bytes, one launch from the "
          f"step's fp32 operands, w1 contiguous: "
          f"{pack[1].is_contiguous()}) == the step's == its plain "
          f"version, bit for bit; kernel "
          f"{k:.4f} ms, plain {pl:.4f} ms, bound {b:.4f} ms ({by}; median "
          f"of 10; {card})", flush=True)
    result.update(err=0.0, ms=k, plain_ms=pl, bound_ms=b, bound_by=by)


def kernels_a_and_b(name: str, args):
    """The CUDA-event times of one call's kernel A launches alone and of
    its kernel B launches alone (on the records kernel A left), for K4, K5,
    K8 or K13 (`name`) on its wrapper's arguments `args` -> (kernel A ms,
    kernel B ms, the call's StashPlan)."""
    import torch

    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels import wgrad_sm90 as wg
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    f_out, S = args[-2], args[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ft.stash_plan(f_out.shape[0] // S, S, sms,
                         name in ft.RECOMPUTE_KERNELS)
    sc = ft.stash_scratch(plan, f_out.device, ft.STASH_KERNELS[name])
    partial = torch.empty((plan.slices, wg.PARTIAL_FLOATS),
                          device=f_out.device)
    ka = cuda_ms(lambda: [ft.kernel_a(lib, name, plan, c, args[:-1], sc)
                          for c in plan.chunks])
    kb = cuda_ms(lambda: [
        wg.contract(sc.stash[:plan.blocks * (t1 - t0)], partial,
                    accumulate=i > 0, label=ft.WGRAD_LABELS.get(name))
        for i, (t0, t1) in enumerate(plan.chunks)])
    return ka, kb, plan


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
                  report=("loss_mid_fine",), evals=None):
    """The train CLI for TRAIN_STEPS full-width steps of `method` on the
    sphere at FRAME_RES, from zeroed launch counts: every forward kernel's
    launches equal per_step x TRAIN_STEPS (absent kernels: zero); the
    calls of the backward kernels K4, K5 and K8 (STASH_KERNELS) per_step x
    TRAIN_STEPS, each kernel's kernel A launched once per chunk of each of
    its calls' stash_plan (whose chunks follow the reflect bucket; the
    calls are recorded, a call made during a capture once per replay of
    it) and kernel B once per chunk of all of them; the loop replays
    captured steps; every
    logged loss finite, loss_mid_fine lower over the last 10 steps than
    over the first 10, the warmup's zeros before step 50, the final
    checkpoint; the means of the `report` losses are printed.  evals:
    (steps_per_eval_batch, steps_per_eval_image) to run the eval hooks at
    (else the defaults, 100 and 500: none in the run); their renders add
    K1 launches, their lines and panels are checked.  -> (run dir, the
    launches of the kernels in per_step, and of kernel B if it ran)."""
    import numpy as np
    import torch

    from rsn_torch.cli import train as train_cli
    from rsn_torch.cli.run_io import load_config
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft

    argv = [method, "--data", f"sphere:res={FRAME_RES}",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16", *flags,
            "--max-num-iterations", str(TRAIN_STEPS),
            "--steps-per-log", "1", "--seed", str(SEED), "--output-dir", tmp]
    if evals:
        argv += ["--steps-per-eval-batch", str(evals[0]),
                 "--steps-per-eval-image", str(evals[1])]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    real = {k: getattr(ft, k) for k in ft.STASH_KERNELS}
    chunks = {k: [] for k in ft.STASH_KERNELS}

    def recording(name):
        def fn(*args):  # g_bands: args[1] (K5) or args[2]
            g = args[1] if name == "field_backward_v6" else args[2]
            chunks[name].append(len(ft.stash_plan(g.shape[0], args[-1],
                                                  sms).chunks))
            return real[name](*args)
        return fn

    buf = io.StringIO()
    ff.reset_launch_counts()
    for k in real:
        setattr(ft, k, recording(k))
    with recorded_captures(chunks) as captures:
        try:
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main(argv)
        finally:
            for k, fn in real.items():
                setattr(ft, k, fn)
    torch.cuda.synchronize()
    launches = dict(ff.LAUNCHES)
    text = buf.getvalue().splitlines()
    print("\n".join(text[:3] + ["  ..."] + text[-3:]))
    if rc != 0:
        raise RuntimeError(f"train CLI exited {rc}")
    print("  captured steps: " + "; ".join(
        f"{c.replays} replays of a capture ({c.seconds:.3f} s)"
        for c, _ in captures))
    if not any(c.replays for c, _ in captures):
        raise RuntimeError("the train CLI did not replay captured steps")
    want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
    # a call made while a step was captured runs once per replay
    for cap, calls in captures:
        for k, c in calls.items():
            chunks[k] += c * cap.replays
    for k, c in chunks.items():
        if len(c) != want[k]:
            raise RuntimeError(f"{len(c)} {k} calls, not {per_step.get(k, 0)}"
                               f" per step")
        want[k] = sum(c)
        if c:
            print(f"  {k}: {len(c)} calls of {min(c)}-{max(c)} chunks, "
                  f"{sum(c)} chunks in all: kernel A launched once per chunk")
    want["field_backward_v4_wgrad"] = sum(map(sum, chunks.values()))
    if evals:
        # K1 on all four passes of each eval batch and of each chunk of
        # each eval image's full render (re-renders at a larger reflect
        # bucket included)
        batches, images = TRAIN_STEPS // evals[0], TRAIN_STEPS // evals[1]
        n_chunks = -(-FRAME_RES * FRAME_RES // CHUNK)
        k1 = launches["field_forward_v3"]
        renders, rest = divmod(k1 - 4 * batches, 4 * n_chunks)
        print(f"  K1 in the eval hooks: {k1} launches = 4 x {batches} eval "
              f"batches + 4 x {n_chunks} chunks x {renders} renders of "
              f"{images} eval images")
        if rest or renders < images:
            raise RuntimeError("the eval hooks did not run K1 as expected")
        want["field_forward_v3"] = k1
    print(f"  launches in the CLI run: {launches}")
    if launches != want:
        raise RuntimeError(f"the train path's launches are not {want}")
    run = re.search(r"run dir: (\S+)", buf.getvalue()).group(1)
    with open(os.path.join(run, "train_log.jsonl")) as fh:
        lines = [json.loads(line) for line in fh]
    log = [e for e in lines if "total_loss" in e]
    if [e["step"] for e in log] != list(range(1, TRAIN_STEPS + 1)):
        raise RuntimeError("expected one log line per step")
    if any("mask_fraction" in e or "reflect_overflow" in e for e in log):
        raise RuntimeError("telemetry in the log without debug_telemetry")
    eval_steps = check_eval_lines(run, lines, evals) if evals else []
    keys = [k for k in log[0] if k.startswith(
        ("loss", "predicted", "orientation", "interlevel", "distortion",
         "total"))]
    if not all(np.isfinite(e[k]) for e in log for k in keys):
        raise RuntimeError("a logged loss is not finite")
    means = {k: (float(np.mean([e[k] for e in log[:10]])),
                 float(np.mean([e[k] for e in log[-10:]])))
             for k in report}
    warm = all(e["orientation_loss_fine"] == 0 for e in log[:49])
    mask = re.findall(r"mask fraction ([\d.]+)", buf.getvalue())[-1]
    print(f"  {len(keys)} loss keys finite on every step; " + "; ".join(
        f"mean {k} steps 1-10 {a:.6g}, steps {TRAIN_STEPS - 9}-"
        f"{TRAIN_STEPS} {b:.6g}" for k, (a, b) in means.items())
        + f"; normal losses zero before step 50: {warm}; mask fraction at "
        f"the end {mask}, reflect bucket {log[-1]['reflect_fraction']}")
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
    rays = load_config(run).pipeline.datamanager.train_num_rays_per_batch
    a, rate = steady_rate(log, eval_steps, rays)
    print(f"  train throughput, steps {a + 1}-{TRAIN_STEPS}: {rate:.1f} "
          f"rays/s (from the cumulative rays_per_sec of the lines at steps "
          f"{a} and {TRAIN_STEPS}; over the whole run "
          f"{log[-1]['rays_per_sec']:.1f}; {card})", flush=True)
    mine = set(per_step) | {"field_backward_v4_wgrad"}
    return run, {k: v for k, v in launches.items() if k in mine}


@contextlib.contextmanager
def recorded_captures(calls):
    """Within: every step the trainer captures, with the calls that the
    capture made, taken out of `calls` ({kernel: [a value per call]}: a
    capture runs nothing) -> [(its CapturedStep, {kernel: those values})];
    each of those runs once per replay."""
    from rsn_torch.engine import trainer as trainer_lib

    real = trainer_lib.Trainer._capture
    captures = []

    def capture(self, frac):
        mark = {k: len(v) for k, v in calls.items()}
        captured = real(self, frac)
        made = {}
        for k, v in calls.items():
            made[k] = v[mark[k]:]
            del v[mark[k]:]
        captures.append((captured, made))
        return captured

    trainer_lib.Trainer._capture = capture
    try:
        yield captures
    finally:
        trainer_lib.Trainer._capture = real


def steady_rate(log, eval_steps, rays: int):
    """rays_per_sec counts from the run's start, so the steady rate between
    two log lines comes from their cumulative counts: from the line after
    the warm-up steps (10) and after the last eval hook before the end, to
    the last line.  log: the train lines of steps 1..TRAIN_STEPS -> (the
    first line's step, rays/s)."""
    a = max([10] + [s + 1 for s in eval_steps if s < len(log)])

    def elapsed(e):
        return e["step"] * rays / e["rays_per_sec"]

    return a, (len(log) - a) * rays / (elapsed(log[-1]) - elapsed(log[a - 1]))


def check_eval_lines(run, lines, evals):
    """The eval hooks' lines at their cadences (rsn's keys), a fine SSIM in
    [0, 1], and each eval image's three panels at FRAME_RES -> the steps at
    which a hook ran."""
    import numpy as np

    batch_steps = list(range(evals[0], TRAIN_STEPS + 1, evals[0]))
    image_steps = list(range(evals[1], TRAIN_STEPS + 1, evals[1]))
    ev = [e for e in lines if "eval_loss" in e]
    im = [e for e in lines if "eval_image_psnr" in e]
    image_keys = {"step"} | {f"eval_image_{k}" for k in (
        "fine_psnr", "fine_ssim", "coarse_psnr", "psnr")}
    if ([e["step"] for e in ev] != batch_steps
            or [e["step"] for e in im] != image_steps
            or any(set(e) != {"step", "eval_loss", "eval_psnr_batch"}
                   for e in ev)
            or any(set(e) != image_keys for e in im)):
        raise RuntimeError("the eval hooks' lines are not rsn's")
    for e in ev + im:
        if not all(np.isfinite(v) for v in e.values()):
            raise RuntimeError(f"a non-finite eval value: {e}")
    ssims = [e["eval_image_fine_ssim"] for e in im]
    if not all(0.0 <= v <= 1.0 for v in ssims):
        raise RuntimeError(f"fine SSIM outside [0, 1]: {ssims}")
    for step in image_steps:
        for name, width in (("img", 3), ("accumulation", 2), ("depth", 2)):
            px = png_pixels(os.path.join(run, "eval_images",
                                         f"{step:09d}-{name}.png"))
            if px.shape != (FRAME_RES, FRAME_RES * width * 3):
                raise RuntimeError(f"eval panel {name}: shape {px.shape}")
    print(f"  eval batches at steps {batch_steps}: eval_psnr_batch "
          + ", ".join(f"{e['eval_psnr_batch']:.4f}" for e in ev)
          + f"; eval images at steps {image_steps}: fine psnr "
          + ", ".join(f"{e['eval_image_fine_psnr']:.4f}" for e in im)
          + f", fine ssim {', '.join(f'{v:.6f}' for v in ssims)}; panels "
          f"img, accumulation, depth at {FRAME_RES} rows")
    return sorted(set(batch_steps + image_steps))


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
    from rsn_torch.cli import render as render_cli

    text, launches = run_cli(render_cli.main, [
        "--load-dir", run, "--mode", "orbit", "--output-dir", frames_dir,
        *flags])
    stats = [tuple(float(x) for x in m) for m in re.findall(
        r"rendered \d+/\d+: ([\d.]+) s, ([\d.]+) rays/s, mask fraction "
        r"([\d.]+), reflect bucket ([\d.]+), rgb range \[([-\d.e]+), "
        r"([-\d.e]+)\]", text)]
    return text, stats, launches


def train_entry_point(card):
    """Phase 8: the train CLI for TRAIN_STEPS steps, then one orbit frame
    of the trained run -> the training kernels' launches of the run."""
    with tempfile.TemporaryDirectory() as tmp:
        run, launches = run_train_cli(
            card, "reflect-sampling-nerf", (),
            {"field_forward_v6": 4, "field_backward_v6": 2,
             "field_backward_v5": 2, "train_blob": 1}, tmp,
            evals=(20, TRAIN_STEPS))
        print(f"  kernel B: {launches['field_backward_v4_wgrad']} launches "
              f"= the chunks of K5's and K4's calls")
        frames = os.path.join(tmp, "frames")
        text, _, _ = run_render_cli(run, frames, "--num-frames", "1",
                                    "--downscale-factor", "4")
        print(text, end="")
        px = png_pixels(os.path.join(frames, "frame_00000.png"))
        side = FRAME_RES // 4
        if px.shape != (side, side * 3) or px.min() == px.max():
            raise RuntimeError("the trained run's orbit frame failed")
    return launches


def train_phases(config, field, device, card, no_spill):
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
    results = check_train_kernels(calls, card, no_spill)
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


def check_prop_kernel(calls, card, first):
    """Phase 9's comparisons and times -> K9's results.  first: the build
    of proposal_forward.cu with RSN_K9_FIRST_DESIGN (phase 2)."""
    import torch

    from rsn_torch.kernels import proposal_forward as pf
    from rsn_torch.kernels.build import load_library

    result = {"err": 0.0}
    for p, (packed, mc) in zip((1, 3), calls):
        got = pf.prop_forward(packed, mc)
        ref = pf.prop_forward_plain(packed, mc)
        old = pf.launch_prop(first, packed, mc)
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
        if not torch.equal(got.view(torch.int32), old.view(torch.int32)):
            raise RuntimeError(f"K9 pass {p} differs from its first design")
        print(f"  K9 pass {p} == its first design (RSN_K9_FIRST_DESIGN), "
              f"bit for bit")
        result["err"] = max(result["err"], err)
    new = load_library("proposal_forward.cu")
    for p, (packed, mc) in zip((1, 3), calls):
        n = mc.shape[0]
        k = cuda_ms(lambda: pf.prop_forward(packed, mc))
        pl = cuda_ms(lambda: pf.prop_forward_plain(packed, mc))
        turns = [back_to_back_ms(lambda: pf.launch_prop(lib, packed, mc))
                 for lib in (first, new, new, first)]
        b, by = bound(FLOPS["prop_forward"] * n,
                      n * PROP_ROW_BYTES + PROP_PARAM_BYTES,
                      PROP_FP32_OPS * n)
        print(f"  K9 pass {p}: {n} rows, kernel {k:.4f} ms, plain {pl:.4f} "
              f"ms, bound {b:.4f} ms ({by}; one wrapper call, median of "
              f"10); in turns, the first design {turns[0]:.4f} / "
              f"{turns[3]:.4f} ms, K9 {turns[1]:.4f} / {turns[2]:.4f} ms "
              f"(5 launches back to back, median of 10; {card})",
              flush=True)
        if p == 1:
            result.update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
            try:  # a reading only: no check depends on the SASS's layout
                k9_instruction_floor(n, card)
            except (ValueError, OSError, subprocess.CalledProcessError) as e:
                print(f"  K9's SASS not counted ({type(e).__name__}: {e})")
    return result


# SASS opcodes by the unit that runs them: FP32 arithmetic (the FMA pipes,
# 128 lanes an SM), the SFU (MUFU, 16 lanes an SM), conversions
K9_FP32_OPS = ("FFMA", "FMUL", "FADD", "FSEL", "FSETP", "FMNMX", "FSWZADD")
K9_CONVERSIONS = ("F2I", "I2F", "I2FP", "F2F", "F2FP", "FRND")


def k9_sass_counts(text: str):
    """K9's SASS (cuobjdump) -> {region: Counter of opcodes}, per warp tile
    of 16 rows on the fast path: "ipe" from the tile loop's head to its
    first product (the IPE and the next tile's loads), "layers" the layer
    loop's body times the 4 layers, "head" the rest of the tile loop.
    sinf's slow path (the branch taken for |x| >= 105615, Payne-Hanek) is
    left out: no phase of this data reaches it."""
    import collections

    ins = []
    for line in text.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?);", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    slow, back = set(), []
    for i, (a, t) in enumerate(ins):
        m = re.search(r"BRA (0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            back.append((int(m.group(1), 16), a))
        m = re.match(r"FSETP\.\S+ (P\d), PT, \|R\d+\|, 105615", t)
        if m:
            for b, u in ins[i + 1:]:
                jump = re.match(rf"@!{m.group(1)} BRA (0x[0-9a-f]+)", u)
                if jump:
                    end = int(jump.group(1), 16)
                    slow.update(c for c, _ in ins if b < c < end)
                    break
    top, bottom = max(back, key=lambda r: r[1] - r[0])
    hmma = [a for a, t in ins if top <= a <= bottom and "HMMA" in t]
    inner = [r for r in back if r != (top, bottom) and top <= r[0]
             and r[1] <= bottom and any(r[0] <= a <= r[1] for a in hmma)]
    lo, hi = max(inner, key=lambda r: r[1] - r[0])
    counts = {k: collections.Counter() for k in ("ipe", "layers", "head")}
    for a, t in ins:
        if not top <= a <= bottom or a in slow:
            continue
        op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
        if lo <= a <= hi:
            counts["layers"][op] += 4
        elif a < min(hmma):
            counts["ipe"][op] += 1
        elif a > hi:
            counts["head"][op] += 1
    return counts


def k9_instruction_floor(n: int, card: str) -> None:
    """The floors that K9's own instructions set at n rows: its SASS
    counted per row (k9_sass_counts: a warp instruction is 32 lanes' work,
    a warp tile 16 rows), over the card's FP32 issue rate (SMs x 128
    lanes), its SFU rate (SMs x 16) and its issue rate (SMs x 4 warp
    instructions) at the clock of PEAK_FP32 (SMs x 128 lanes x 2 FLOP)."""
    import collections

    import torch

    from rsn_torch.kernels.build import sass

    counts = k9_sass_counts(sass("proposal_forward.cu"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = PEAK_FP32 / (132 * 128 * 2)
    lanes_per_row = 32 / 16

    def per_row(region, ops=None):
        c = counts[region] if region else sum(counts.values(),
                                               collections.Counter())
        return lanes_per_row * sum(v for k, v in c.items()
                                   if ops is None or k in ops)

    ipe_fp32, ipe_mufu = per_row("ipe", K9_FP32_OPS), per_row("ipe",
                                                               ("MUFU",))
    ipe_conv, ipe_all = per_row("ipe", K9_CONVERSIONS), per_row("ipe")
    all_fp32, all_ops = per_row(None, K9_FP32_OPS), per_row(None)
    ms = {name: 1e3 * n * v / (sms * lanes * clock) for name, v, lanes in (
        ("ipe_fp32", ipe_fp32, 128), ("ipe_mufu", ipe_mufu, 16),
        ("ipe_issue", ipe_all, 128), ("fp32", all_fp32, 128),
        ("issue", all_ops, 128))}
    print(f"  K9's SASS per row (fast path; {n} rows, {sms} SMs at "
          f"{clock / 1e9:.2f} GHz): the IPE region {ipe_all:.0f} "
          f"instructions, {ipe_fp32:.0f} FP32, {ipe_mufu:.0f} MUFU, "
          f"{ipe_conv:.0f} conversions -> its floor "
          f"{max(ms['ipe_fp32'], ms['ipe_mufu']):.4f} ms (FP32 "
          f"{ms['ipe_fp32']:.4f}, SFU {ms['ipe_mufu']:.4f}; its issue "
          f"slots {ms['ipe_issue']:.4f}); the whole tile loop {all_ops:.0f} "
          f"instructions, {all_fp32:.0f} FP32, "
          f"{per_row(None, ('HMMA',)):.0f} HMMA -> FP32 {ms['fp32']:.4f} "
          f"ms, issue {ms['issue']:.4f} ms ({card})", flush=True)
    for region, c in counts.items():
        print(f"    {region}: " + ", ".join(
            f"{k} {lanes_per_row * v:.0f}" for k, v in c.most_common(12)))


def preset_phases(field, field_cpu, orbit, device, card, k9_first):
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
    result = check_prop_kernel(calls, card, k9_first)
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
             "field_backward_v5": 1, "train_blob": 1}, tmp,
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
        print(f"  K9 and K1 each twice per chunk, {2 * chunks} launches "
              f"each a frame: {k9 // (2 * chunks)} renders of {chunks} "
              f"chunks for 3 frames (re-renders included)")
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
                     "field_backward_v4", "field_backward_v4_wgrad")
# the weight matrices w0..w7, w_hc of the 20 gradients: kernel B's sums
# over the rows, held to K13's first design's (per-block slices, the
# RSN_K13_FIRST_DESIGN build) within K13_TOL; K8's other outputs are the
# body's own
K8_WEIGHTS = tuple(range(8)) + (16,)
# kernel B's products per row: w0 and w4's x part on the IPE's 99 live
# columns, w1-w3, w5-w7 and w4's hs3 part, w_hc's 144 live columns
WGRAD_MACS = IPE_DIM * 256 * 2 + 7 * 256 * 256 + 256 * 144


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
    "bwd": {pass: (packed, mc, g, d_out, f_out, S)}, "blob": the
    forwards' weight blob} for passes 1-4, the backward calls of the first
    of the step's two backward passes (each matched to its pass by the
    forward output it differentiates)."""
    import torch

    from rsn_torch.kernels import field_train as ft

    fwd, bwd, blobs = [], [], []
    real = (ft.field_forward_v4, ft.field_forward_v3_train,
            ft.field_backward_v4)

    # clones: the packed biases share the parameters' storage, which the
    # optimizer step then updates in place
    def recording(forward):
        def fn(packed, mc, g, S, blob=None):
            out = forward(packed, mc, g, S, blob=blob)
            fwd.append((tuple(t.clone() for t in packed), mc.clone(),
                        g.clone(), S, out.clone()))
            blobs.append(blob)
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
    calls = {"fwd": dict(enumerate(fwd, start=1)), "bwd": {},
             "blob": one_blob(blobs)}
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


def weights_against_k13(k8, k13) -> float:
    """The largest error of K8's weight matrices over each of K13's first
    design's (the first design's body, which sums the per-block
    slices)."""
    return max(rel_err(k8[2][i], k13[2][i]) for i in K8_WEIGHTS)


def kernel_b_on_a_chunk(records, label: str, card, tag: str):
    """Kernel B (counted under `label`) alone on one chunk's `records` that
    a kernel A left, against its plain contraction and cuBLAS on the same
    operands -> its result row (err, ms, plain_ms, bound_ms, bound_by,
    library_ms)."""
    import torch

    from rsn_torch.kernels import wgrad_sm90 as wg

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slices = wg.slices_for(sms, records.shape[0])
    got = torch.empty((slices, wg.PARTIAL_FLOATS), device=records.device)
    ref = torch.empty_like(got)
    wg.contract(records, got, accumulate=False, label=label)
    wg.contract_plain(records, ref, accumulate=False)
    torch.cuda.synchronize()
    err = max(rel_err(a, r) for a, r in zip(wg.weight_grads(got),
                                            wg.weight_grads(ref)))
    k = cuda_ms(lambda: wg.contract(records, got, accumulate=False,
                                    label=label))
    pl = cuda_ms(lambda: wg.contract_plain(records, ref, accumulate=False))
    lib_ms, lib_err, how = cublas_contraction(records, wg.weight_grads(got))
    b, by = bound(2 * WGRAD_MACS * records.shape[0] * wg.REC_ROWS,
                  nbytes(records, got))
    print(f"  kernel B on {tag} ({records.shape[0]} records, "
          f"{records.shape[0] * wg.REC_ROWS} rows, P = {slices}): within "
          f"{err:.6g} of its plain fp32 contraction (limit {K13_TOL}); "
          f"kernel {k:.4f} ms, plain {pl:.4f} ms, cuBLAS {lib_ms:.4f} ms "
          f"(4 calls, {how}; within {lib_err:.6g} of kernel B), bound "
          f"{b:.4f} ms ({by}; median of 10; {card})", flush=True)
    if err > K13_TOL:
        raise RuntimeError("kernel B disagrees with its plain version")
    return dict(err=err, ms=k, plain_ms=pl, bound_ms=b, bound_by=by,
                library_ms=lib_ms)


def check_recompute_kernels(calls, card, first13):
    """Phase 12's comparisons and times -> per-kernel results.  first13:
    the build of field_train.cu with RSN_K13_FIRST_DESIGN (phase 2)."""
    import torch

    from rsn_torch.kernels import field_train as ft

    results = {k: {"err": 0.0} for k in RECOMPUTE_KERNELS}
    for p in (2, 4):
        packed, mc, g, S, out = calls["fwd"][p]
        normals = p <= 2
        name = "field_forward_v4" if normals else "field_forward_v3_train"
        tag = "K7" if normals else "K1 train width"
        got = getattr(ft, name)(packed, mc, g, S, blob=calls["blob"])
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
        k13 = ft.field_backward_v3_first_design(first13, bpacked, bmc, bg,
                                                d_out, f_out, bS)
        torch.cuda.synchronize()
        if not same_grads(k8, k8b):
            raise RuntimeError(f"K8 pass {p} differs from itself")
        if not same_grads(k8, k4):
            raise RuntimeError(f"K8 pass {p} differs from K4 on K3's spill")
        werr = weights_against_k13(k8, k13)
        del k13
        if werr > K13_TOL:
            raise RuntimeError(f"K8 pass {p}: weight gradients {werr:.6g} "
                               f"from K13's first design's (limit "
                               f"{K13_TOL})")
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
        print(f"  K8 pass {p}: rows {bmc.shape[0]}, == itself and == K4 on "
              f"K3's spill (dmc, dg, all 20 gradients) bit for bit; w0..w7, "
              f"w_hc within {werr:.6g} of K13's first design's (its "
              f"per-block slices, RSN_K13_FIRST_DESIGN; limit {K13_TOL}); "
              f"max error over each tensor's max: "
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
        k = cuda_ms(lambda: fn(packed, mc, g, S, blob=calls["blob"]))
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
    # K8 on passes 4 and 2: both kernels, kernel A's launches over the
    # call's chunks alone and kernel B's alone (on the records kernel A
    # left), K13's first design (the first design's body, + its grid sum)
    # and K4 on K3's spill in the same call; the scratch of each design
    from rsn_torch.kernels import wgrad_sm90 as wg

    for p in (4, 2):
        args = calls["bwd"][p]
        packed, mc, g, d_out, f_out, S = args
        n = mc.shape[0]
        k = cuda_ms(lambda: ft.field_backward_v4(*args))
        ka, kb, plan = kernels_a_and_b("field_backward_v4", args)
        k13 = cuda_ms(lambda: ft.field_backward_v3_first_design(first13,
                                                                 *args))
        pl = cuda_ms(lambda: ft.field_backward_v4_plain(*args))
        outs = g.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + n * 16 * 4
        b, by = bound(FLOPS["field_backward_v4"] * n,
                      nbytes(mc, g, d_out, f_out) + w_bytes + outs)
        _, acts = ft.field_forward_v6(packed, mc, g, S)
        k4 = cuda_ms(lambda: ft.field_backward_v5(packed, mc, g, acts, d_out,
                                                  f_out, S))
        del acts
        first = plan.blocks * (ft.PACK_FLOATS * 4 + ft.TILE_ROWS
                               * ft.ACTS_COLS * 2)
        print(f"  K8 pass {p}: {n} rows, kernel {k:.4f} ms (kernel A alone "
              f"{ka:.4f} ms, kernel B alone {kb:.4f} ms over "
              f"{len(plan.chunks)} chunks of {plan.blocks} blocks x up to "
              f"{ft.TILES_PER_CHUNK} tiles, P = {plan.slices}); K13's first "
              f"design {k13:.4f} ms in the same call; plain "
              f"{pl:.4f} ms, bound {b:.4f} ms ({by}); K4 on K3's spill "
              f"{k4:.4f} ms (median of 10; {card})", flush=True)
        peak = {}
        for tag, fn in (("K8", ft.field_backward_v4),
                        ("first", lambda *a: ft.field_backward_v3_first_design(
                            first13, *a))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = fn(*args)
            torch.cuda.synchronize()
            peak[tag] = torch.cuda.max_memory_allocated() - base
            del res
        print(f"  K8 pass {p} scratch per call: {plan.scratch_bytes()} bytes "
              f"(the first design's: {first}); the peak of one call above "
              f"what was allocated before it: K8 {peak['K8']} bytes, K13's "
              f"first design {peak['first']} bytes",
              flush=True)
        results["field_backward_v4"].update(ms=k, plain_ms=pl, bound_ms=b,
                                            bound_by=by)

    # kernel B alone on the records kernel A left of pass 2's last chunk,
    # against its plain contraction, and cuBLAS on the same operands
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    args = calls["bwd"][2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ft.stash_plan(args[2].shape[0], args[5], sms)
    sc = ft.stash_scratch(plan, args[1].device)
    ws = [ft.kernel_a(lib, "field_backward_v4", plan, c, args[:5], sc)
          for c in plan.chunks][-1]
    results["field_backward_v4_wgrad"].update(kernel_b_on_a_chunk(
        ws, wg.FOLDED.label, card, "pass 2's last chunk"))
    return results


def cublas_contraction(ws, want):
    """Kernel B's function through cuBLAS: a chunk's records unpacked to
    row-major operands (not timed), then one torch.bmm over the six
    256 x 256 layers (w1-w3, w5-w7) and torch.mm for w0, w4 and w_hc's 144
    live columns, bf16 in, fp32 accumulate (fp32 out where this torch
    takes out_dtype, else bf16 out) -> (the four calls' CUDA-event ms,
    their largest error over each of `want`'s maxima, the output dtype)."""
    import torch

    from rsn_torch.kernels import wgrad_sm90 as wg

    rows = ws.shape[0] * wg.REC_ROWS
    feats = lambda off, f: wg._unswizzle(ws[:, off:off + f * wg.REC_ROWS],
                                         f).reshape(rows, f).contiguous()
    step = 256 * wg.REC_ROWS
    x = feats(wg.X_OFF, 128)
    hs = [feats(wg.ACT_OFF + i * step, 256) for i in range(8)]
    dpre = [feats(wg.DPRE_OFF + i * step, 256) for i in range(8)]
    dhc = feats(wg.DHC_OFF, wg.HEAD_N)
    six = (1, 2, 3, 5, 6, 7)
    a6 = torch.stack([hs[i - 1] for i in six]).transpose(1, 2)
    b6 = torch.stack([dpre[i] for i in six])
    x4 = torch.cat([x, hs[3]], dim=1)
    try:
        torch.mm(x.t(), dpre[0], out_dtype=torch.float32)
        kw, how = {"out_dtype": torch.float32}, "fp32 out"
    except (TypeError, RuntimeError):
        kw, how = {}, "bf16 out"

    def four():
        return (torch.bmm(a6, b6, **kw), torch.mm(x.t(), dpre[0], **kw),
                torch.mm(x4.t(), dpre[4], **kw),
                torch.mm(hs[7].t(), dhc, **kw))

    w6, w0, w4, whc = four()
    ms = cuda_ms(four)
    ws_ = {0: w0, 4: w4}
    ws_.update({i: w6[j] for j, i in enumerate(six)})
    errs = [rel_err(ws_[i], want[i]) for i in range(8)]
    errs.append(rel_err(whc[:, :wg.HEAD_COLS], want[8][:, :wg.HEAD_COLS]))
    errs.append(rel_err(whc[:, wg.HEAD_COLS:],
                        want[8][:, 256 - (wg.HEAD_N - wg.HEAD_COLS):]))
    return ms, max(errs), how


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


def camera_phases(config, field, device, card, first13):
    """Phases 12-15 -> {"kernels": K7's, K1 train width's and K8's results,
    "launches": their launches in the camera-on train CLI run, "calls":
    phase 12's captured kernel inputs}.  first13: the build of
    field_train.cu with RSN_K13_FIRST_DESIGN (phase 2)."""
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
        results = check_recompute_kernels(calls, card, first13)
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
             "field_backward_v4": 8, "train_blob": 1}, tmp)
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
               "field_backward_v3", "field_backward_v3_wgrad",
               "field_backward_v3_sum")


def api_phase(field, render_mc, cam_calls, card, first, first13):
    """Phase 16 -> {"kernels": K10-K13's results, "launches": their
    launches in the run of this slice's path (the field's kernel route and
    the kernel API; no CLI path calls them, as in rsn)}.  first: the build
    of field_forward.cu with RSN_K11_FIRST_DESIGN, first13: of
    field_train.cu with RSN_K13_FIRST_DESIGN and RSN_K10_FIRST_DESIGN
    (phase 2)."""
    import torch

    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft

    phase("phase 16: K10-K13 against plain versions at main-path shapes")
    fpacked, fmc, g, S, _ = cam_calls["fwd"][2]  # pass 2: with the normals
    bwd = {p: cam_calls["bwd"][p] for p in (2, 4)}
    blob = cam_calls["blob"]  # the step's train blob, as K7 reads it
    ff.reset_launch_counts()
    route = field.get_field_outputs(render_mc[:, 0:3], render_mc[:, 3:6],
                                    use_pallas=True, differentiable=False)
    packed = ff.pack_params(field)
    enc = ff.ipe_enc(render_mc)
    k12 = ff.field_forward(packed, enc)
    k10 = {True: ft.field_forward_v5(fpacked, fmc, g, S, True, blob=blob),
           False: ft.field_forward_v5(fpacked[:20], fmc, g, S, False,
                                      blob=blob)}
    k13 = {p: ft.field_backward_v3(*args) for p, args in bwd.items()}
    torch.cuda.synchronize()
    launches = {k: ff.LAUNCHES[k] for k in API_KERNELS}
    print(f"  launches in the path's run (the kernel route, the kernel API): "
          f"{launches}; the CLI runs launch none of them (no CLI caller, as "
          f"in rsn)")
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the field API never launched")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {p: ft.stash_plan(a[2].shape[0], a[5], sms)
             for p, a in bwd.items()}
    chunks = sum(len(pl.chunks) for pl in plans.values())
    want = {"field_backward_v3": chunks, "field_backward_v3_wgrad": chunks,
            "field_backward_v3_sum": len(bwd)}
    print(f"  K13: kernel A and kernel B once per chunk of each call "
          f"({chunks} chunks over passes 2 and 4), its sum once per call: "
          f"{want}", flush=True)
    if any(launches[k] != v for k, v in want.items()):
        raise RuntimeError("K13 did not run kernel A and kernel B once per "
                           "chunk and its sum once per call")
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
    del dens
    if torch.any(k12[:, ff.N_HEAD_COLS:] != 0):
        raise RuntimeError("K12's padding columns are not zero")
    for tag, name, got, x in (("K11", "field_forward_v2", k11, render_mc),
                              ("K12", "field_forward", k12, enc)):
        old = ff.launch_heads(first, name, packed, x)
        torch.cuda.synchronize()
        if not torch.equal(old, got):
            raise RuntimeError(f"{tag} differs from its first design")
        del old
    print(f"  K11, K12 == each one's first design (RSN_K11_FIRST_DESIGN), bit "
          f"for bit ({n} rows); padding columns zero", flush=True)
    del k11, k12, got

    # K10 on the camera-on step's pass 2, both flags: against K7 / K1 at
    # the train width and its first design (the RSN_K10_FIRST_DESIGN
    # build), which also holds K7 / K1 to the 64-row forward's sum order
    k7 = ft.field_forward_v4(fpacked, fmc, g, S, blob=blob)
    k1 = ft.field_forward_v3_train(fpacked[:20], fmc, g, S, blob=blob)
    old = {nm: ft.field_forward_v5_first_design(
        first13, fpacked if nm else fpacked[:20], fmc, g, S, nm, blob)
        for nm in (True, False)}
    torch.cuda.synchronize()
    if not (torch.equal(k10[True], k7) and torch.equal(k10[False], k1)):
        raise RuntimeError("K10 differs from K7 or K1 at the train width")
    if not (torch.equal(k10[True], old[True])
            and torch.equal(k10[False], old[False])):
        raise RuntimeError("K10 differs from its first design")
    if not (torch.equal(k7, old[True]) and torch.equal(k1, old[False])):
        raise RuntimeError("K7 or K1 at the train width differs from K10's "
                           "first design")
    print(f"  K10 pass 2 ({fmc.shape[0]} rows), both flags: == K7 (normals) "
          f"and == K1 at the train width, == its first design "
          f"(RSN_K10_FIRST_DESIGN: the 64-row wmma forward), and K7 / K1 == "
          f"that first design, bit for bit")
    del old
    for normals in (True, False):
        ref = ft.field_forward_v4_plain(fpacked if normals else fpacked[:20],
                                        fmc, g, S, normals)
        err = compare(f"K10 pass 2 (normals={normals})", k10[normals], ref,
                      list(range(14)) + list(range(17, 20)))
        results["field_forward_v5"]["err"] = max(
            results["field_forward_v5"]["err"], err)

    # K13 on K8's captured inputs of passes 2 and 4: against its first
    # design, K8, itself and its plain version; its sum against its plain
    # version on the same slices and partials
    r13 = results["field_backward_v3"]
    for p, args in bwd.items():
        again = ft.field_backward_v3(*args)
        old = ft.field_backward_v3_first_design(first13, *args)
        k8 = ft.field_backward_v4(*args)
        torch.cuda.synchronize()
        if not same_grads(k13[p], again):
            raise RuntimeError(f"K13 pass {p} differs from itself")
        for tag, ref in (("its first design", old), ("K8", k8)):
            if not (torch.equal(k13[p][0], ref[0])
                    and torch.equal(k13[p][1], ref[1])):
                raise RuntimeError(f"K13 pass {p}: dmc or dg differ from "
                                   f"{tag}'s")
        werr = {tag: max(rel_err(a, b) for a, b in zip(k13[p][2], ref[2]))
                for tag, ref in (("first", old), ("K8", k8))}
        same8 = sum(torch.equal(a, b) for a, b in zip(k13[p][2], k8[2]))
        ulps8 = max(ulps_of_max(a, b) for a, b in zip(k13[p][2], k8[2]))
        plain = ft.field_backward_v4_plain(*args)
        errs = {"dmc": rel_err(k13[p][0], plain[0]),
                "dg": rel_err(k13[p][1], plain[1]),
                "dpacked": max(rel_err(a, b)
                               for a, b in zip(k13[p][2], plain[2]))}
        print(f"  K13 pass {p}: rows {args[1].shape[0]}, == itself; dmc and "
              f"dg == its first design's (RSN_K13_FIRST_DESIGN) and == K8's, "
              f"bit for bit; the 20 gradients within {werr['first']:.6g} of "
              f"the first design's and {werr['K8']:.6g} of K8's (limit "
              f"{K13_TOL}; {same8} of 20 == K8's bit for bit, the largest "
              f"difference {ulps8:.2f} ulp of its tensor's largest value: "
              f"the sums over the P partials and the block slices in another "
              f"order); against its plain "
              f"version: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                       errs.items())
              + f" (limit {K8_TOL})", flush=True)
        if max(werr.values()) > K13_TOL or max(errs.values()) > K8_TOL:
            raise RuntimeError(f"K13 pass {p} disagrees")
        r13["err"] = max(r13["err"], max(errs.values()))
        del old, again, k8

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
        # on the device alone, in turns with the first design (first
        # design, kernel, kernel, first design), 5 calls back to back

        def new(fn=fn, x=x):
            fn(packed, x)

        def old(name=name, x=x):
            ff.launch_heads(first, name, packed, x)
        t = [back_to_back_ms(f) for f in (old, new, new, old)]
        print(f"  {tag}: back to back in turns, the first design {t[0]:.4f} "
              f"/ {t[3]:.4f} ms, the kernel {t[1]:.4f} / {t[2]:.4f} ms "
              f"({(t[0] + t[3]) / (t[1] + t[2]):.2f}x the first design's "
              f"speed; 5 calls back to back, median of 10; {card})",
              flush=True)
    del enc
    nf = fmc.shape[0]
    w_bytes = nbytes(*fpacked[:20])
    for normals in (True, False):
        pk = fpacked if normals else fpacked[:20]
        other = "K7" if normals else "K1 train width"
        ring = ft.field_forward_v4 if normals else ft.field_forward_v3_train

        def new(pk=pk, normals=normals):
            ft.field_forward_v5(pk, fmc, g, S, normals, blob=blob)

        def first(pk=pk, normals=normals):
            ft.field_forward_v5_first_design(first13, pk, fmc, g, S, normals,
                                             blob)

        def same(pk=pk, ring=ring):
            ring(pk, fmc, g, S, blob=blob)
        ms = {"K10": cuda_ms(new), "first": cuda_ms(first),
              other: cuda_ms(same)}
        pl = cuda_ms(lambda: ft.field_forward_v4_plain(pk, fmc, g, S,
                                                       normals))
        flops = (FLOPS["field_forward_v6"] + (2 * DGRAD_MACS if normals
                                              else 0)) * nf
        b, by = bound(flops, nbytes(fmc, g, *pk[20:]) + w_bytes
                      + nf * ft.OUT_TRAIN * 2)
        print(f"  K10 pass 2 (normals={normals}): {nf} rows, kernel "
              f"{ms['K10']:.4f} ms, its first design (the 64-row wmma "
              f"forward) {ms['first']:.4f} ms, {other} {ms[other]:.4f} ms, "
              f"plain {pl:.4f} ms, bound {b:.4f} ms ({by}; one wrapper call, "
              f"median of 10; {card})", flush=True)
        # on the device alone, in turns (5 calls back to back, median of 10)
        t = [back_to_back_ms(f) for f in (new, first, new, first)]
        u = [back_to_back_ms(f) for f in (new, same, new, same)]
        print(f"  K10 (normals={normals}): back to back in turns, the kernel "
              f"{t[0]:.4f} / {t[2]:.4f} ms, its first design {t[1]:.4f} / "
              f"{t[3]:.4f} ms ({(t[1] + t[3]) / (t[0] + t[2]):.2f}x the first "
              f"design's speed); the kernel {u[0]:.4f} / {u[2]:.4f} ms, "
              f"{other} {u[1]:.4f} / {u[3]:.4f} ms (K10 at "
              f"{(u[0] + u[2]) / (u[1] + u[3]):.3f}x {other}'s time; 5 calls "
              f"back to back, median of 10; {card})", flush=True)
        if normals:
            results["field_forward_v5"].update(ms=ms["K10"], plain_ms=pl,
                                               bound_ms=b, bound_by=by)
    # K13 on passes 4 and 2: one call beside its first design's, then back
    # to back in turns with it (new, first, new, first); kernel A, kernel B
    # and the sum apart; each design's scratch
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    for p in (4, 2):
        args = bwd[p]
        _, mc, g8, d_out, f_out, _ = args
        new = lambda: ft.field_backward_v3(*args)
        old = lambda: ft.field_backward_v3_first_design(first13, *args)
        one = (cuda_ms(new), cuda_ms(old))
        k8 = cuda_ms(lambda: ft.field_backward_v4(*args))
        pl = cuda_ms(lambda: ft.field_backward_v4_plain(*args))
        turns = [back_to_back_ms(f) for f in (new, old, new, old)]
        ka, kb, plan = kernels_a_and_b("field_backward_v3", args)
        _, _, small, partial = ft.stash_phases("field_backward_v3", args[:5],
                                               args[5])
        got = ft.k13_sum(small, partial)
        want = torch.cat([x.reshape(-1) for x in
                          ft.k13_sum_plain(small, partial)])
        torch.cuda.synchronize()
        serr = float((got - want).abs().max())
        ks = cuda_ms(lambda: ft.k13_sum(small, partial))
        ps = cuda_ms(lambda: ft.k13_sum_plain(small, partial))
        # the one PyTorch call: partial.sum(0) over the P partials (the
        # kernel's partial totals are the plain version's in-order sum)
        lib_sum = cuda_ms(lambda: partial.sum(0))
        in_order = ft._sum_in_order(partial)
        lerr = float((partial.sum(0) - in_order).abs().max())
        lrel = lerr / max(float(in_order.abs().max()), 1e-30)
        sb, sby = bound(0, nbytes(small, partial, got))
        outs = g8.shape[0] * 512 * 4 + ft.PACK_FLOATS * 4 + mc.shape[0] * 16 * 4
        b, by = bound(FLOPS["field_backward_v4"] * mc.shape[0],
                      nbytes(mc, g8, d_out, f_out) + w_bytes + outs)
        first_scratch = plan.blocks * (ft.PACK_FLOATS * 4 + ft.TILE_ROWS
                                       * ft.ACTS_COLS * 2)
        print(f"  K13 pass {p}: {mc.shape[0]} rows, one call {one[0]:.4f} ms "
              f"against the first design's {one[1]:.4f} ms; back to back in "
              f"turns {turns[0]:.4f} / {turns[2]:.4f} ms against "
              f"{turns[1]:.4f} / {turns[3]:.4f} ms "
              f"({(turns[1] + turns[3]) / (turns[0] + turns[2]):.2f}x); "
              f"kernel A alone {ka:.4f} ms, kernel B alone {kb:.4f} ms over "
              f"{len(plan.chunks)} chunks of {plan.blocks} blocks x up to "
              f"{ft.TILES_PER_CHUNK} tiles, P = {plan.slices}, the sum "
              f"{ks:.4f} ms (plain {ps:.4f} ms, bound {sb:.4f} ms ({sby}), "
              f"== its plain version within {serr:.6g}; partial.sum(0), the "
              f"one PyTorch call, {lib_sum:.4f} ms over the {partial.shape[0]}"
              f" x {partial.shape[1]} partials, within {lerr:.6g} ({lrel:.3g}"
              f" of the largest total) of the in-order sum); K8 {k8:.4f} ms, "
              f"plain {pl:.4f} ms, bound {b:.4f} ms ({by}); scratch per call "
              f"{plan.scratch_bytes()} bytes (the first design's: "
              f"{first_scratch}), both + {ft.PACK_FLOATS * 4} of the "
              f"gradients (median of 10; {card})", flush=True)
        if serr != 0.0:
            raise RuntimeError("K13's sum differs from its plain version")
        if p == 2:
            r13.update(ms=one[0], plain_ms=pl, bound_ms=b, bound_by=by)
            results["field_backward_v3_sum"].update(
                err=serr, ms=ks, plain_ms=ps, bound_ms=sb, bound_by=sby,
                library_ms=lib_sum)
        else:  # kernel B on K13's chunk of pass 4 (512 records)
            sc = ft.stash_scratch(plan, mc.device)
            ws = [ft.kernel_a(lib, "field_backward_v3", plan, c, args[:5], sc)
                  for c in plan.chunks][-1]
            results["field_backward_v3_wgrad"].update(kernel_b_on_a_chunk(
                ws, "field_backward_v3_wgrad", card, "K13 pass 4's chunk"))
            del sc, ws
        del small, partial, got, want, in_order
        torch.cuda.empty_cache()
    return {"kernels": results, "launches": launches}


# ---- the tools' forward experiments (K14-K16) -------------------------------

EXP_FORWARDS = ("field_forward_v3u", "field_forward_v3i",
                "field_forward_v3L", "field_forward_v3F")
K16_TOL = 1e-6      # K16's fp32 modes against their plain versions: the
                    # same operations in the same order (no contraction)
# K16's fp32 operations per element, a sine, exp or rint counted as one
K16_OPS = {"copy": 1, "exact": 2, "poly": 12, "exp": 3, "exp2": 3,
           "exp2_ldexp": 16, "poly_bf16": 26, "cos_poly": 14}


# K16's yardsticks: the one PyTorch call of each mode; all but copy's take
# their argument computed beforehand (t * 2 pi, -|t| / 2, -0.72134752 |t|),
# one multiply and one abs less than the kernel does
LIBRARY_CALLS = {"copy": "x * 2.0", "exact": "torch.sin, precomputed",
                 "poly": "torch.sin, precomputed",
                 "poly_bf16": "torch.sin, precomputed",
                 "cos_poly": "torch.cos, precomputed",
                 "exp": "torch.exp, precomputed",
                 "exp2": "torch.exp2, precomputed",
                 "exp2_ldexp": "torch.exp2, precomputed"}


def library_calls(x):
    """-> {mode: a function making LIBRARY_CALLS[mode]'s one call on x}."""
    import math

    import torch

    arg = {"sin": x * (2.0 * math.pi), "exp": -0.5 * x.abs(),
           "exp2": -0.72134752 * x.abs()}
    return {"copy": lambda: x * 2.0,
            "exact": lambda: torch.sin(arg["sin"]),
            "poly": lambda: torch.sin(arg["sin"]),
            "poly_bf16": lambda: torch.sin(arg["sin"]),
            "cos_poly": lambda: torch.cos(arg["sin"]),
            "exp": lambda: torch.exp(arg["exp"]),
            "exp2": lambda: torch.exp2(arg["exp2"]),
            "exp2_ldexp": lambda: torch.exp2(arg["exp2"])}


def experiments_phase(field, render_mc, render_g, S, card, first):
    """Phase 17 -> {"kernels": K14-K16's results, "launches": their launches
    in the run of this slice's path (the experiments' kernels on the render
    chunk's rows and on the tool's input; no model or CLI path calls them,
    as in rsn)}.  first: the build of experiments.cu with
    RSN_K14_FIRST_DESIGN (phase 2)."""
    import torch

    from rsn_torch.experiments import cheap_sin, interleave, interleave2
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels.build import load_library

    phase("phase 17: K14-K16 against plain versions at main-path shapes")
    p3 = ff.pack_params_v3(field)
    n = render_mc.shape[0]
    args = (p3, render_mc, render_g, S)
    x = cheap_sin.tool_input(n, render_mc.device, seed=SEED)
    ff.reset_launch_counts()
    outs = {"field_forward_v3u": interleave.field_forward_v3u(*args),
            "field_forward_v3i": interleave.field_forward_v3i(*args),
            "field_forward_v3L": interleave2.field_forward_v3L(*args),
            "field_forward_v3F": interleave2.field_forward_v3L(*args, True)}
    for mode in cheap_sin.MODES:
        cheap_sin.run(mode, x)
    torch.cuda.synchronize()
    names = EXP_FORWARDS + tuple(f"cheap_sin_{m}" for m in cheap_sin.MODES)
    launches = {k: ff.LAUNCHES[k] for k in names}
    print(f"  launches in the path's run (the experiments' kernels): "
          f"{launches}; the CLI runs launch none of them (no caller outside "
          f"the tools, as in rsn)")
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the experiments never launched")
    results = {k: {"err": 0.0} for k in names}

    # K14 / K15 on the render chunk's rows
    if not torch.equal(outs["field_forward_v3i"], outs["field_forward_v3u"]):
        raise RuntimeError("v3i differs from v3u")
    if not torch.equal(outs["field_forward_v3F"], outs["field_forward_v3L"]):
        raise RuntimeError("v3F differs from v3L")
    print(f"  v3i == v3u and v3F == v3L, bit for bit ({n} rows)")
    for name, (entry, flags) in interleave.ENTRIES.items():
        old = interleave.launch_kernel(first, entry, *args, *flags)
        torch.cuda.synchronize()
        if not torch.equal(old, outs[name]):
            raise RuntimeError(f"{name} differs from its first design")
        del old
    print(f"  v3u, v3i, v3L, v3F == each one's first design "
          f"(RSN_K14_FIRST_DESIGN), bit for bit ({n} rows)", flush=True)
    k1 = ff.field_forward_v3(ff.pack_params_v3f(field), render_mc, render_g,
                             S)
    plains = {"field_forward_v3u": interleave.field_forward_v3u_plain,
              "field_forward_v3L": interleave2.field_forward_v3L_plain}
    for name in ("field_forward_v3u", "field_forward_v3L"):
        got = outs[name]
        ref = plains[name](*args)
        torch.cuda.synchronize()
        err = compare(f"{name} pass 2", got, ref, list(range(128)))
        del ref
        pair = ("field_forward_v3i" if name.endswith("u")
                else "field_forward_v3F")
        results[name]["err"] = results[pair]["err"] = err
        compare(f"{name} against K1, columns 0:14", got, k1, LIVE_V3)
    del outs, k1

    # times and bounds
    b, by = bound(interleave.FLOPS_PER_ROW * n,
                  nbytes(render_mc, render_g, *p3) + n * interleave.V3_OUT * 2)
    p1 = ff.pack_params_v3f(field)
    ms = {"K1": cuda_ms(lambda: ff.field_forward_v3(
        p1, render_mc, render_g, S))}
    for name, fn, flag in (
            ("field_forward_v3u", interleave.field_forward_v3u, ()),
            ("field_forward_v3i", interleave.field_forward_v3i, ()),
            ("field_forward_v3L", interleave2.field_forward_v3L, (False,)),
            ("field_forward_v3F", interleave2.field_forward_v3L, (True,))):
        ms[name] = cuda_ms(lambda: fn(*args, *flag))
    for name in plains:
        pl = cuda_ms(lambda: plains[name](*args))
        pair = ("field_forward_v3i" if name.endswith("u")
                else "field_forward_v3F")
        for k in (name, pair):
            results[k].update(ms=ms[k], plain_ms=pl, bound_ms=b, bound_by=by)
    print(f"  pass 2 ({n} rows): " + ", ".join(
        f"{k.replace('field_forward_', '')} {v:.4f} ms" for k, v in ms.items())
        + f" (K1 on the same rows, the same call); plain v3u "
        f"{results['field_forward_v3u']['plain_ms']:.4f} ms, plain v3L "
        f"{results['field_forward_v3L']['plain_ms']:.4f} ms; bound {b:.4f} "
        f"ms ({by}; one call per event pair, median of 10; {card})",
        flush=True)
    # on the device alone: each variant in turns with its first design and
    # K1 (first design, kernel, K1, K1, kernel, first design), 5 calls back
    # to back
    def k1():
        ff.field_forward_v3(p1, render_mc, render_g, S)
    for name, (entry, flags) in interleave.ENTRIES.items():
        def new(entry=entry, flags=flags):
            interleave.launch_kernel(load_library("experiments.cu"), entry,
                                     *args, *flags)

        def old(entry=entry, flags=flags):
            interleave.launch_kernel(first, entry, *args, *flags)
        t = [back_to_back_ms(f) for f in (old, new, k1, k1, new, old)]
        print(f"  {name.replace('field_forward_', '')}: back to back in "
              f"turns, the first design {t[0]:.4f} / {t[5]:.4f} ms, the "
              f"kernel {t[1]:.4f} / {t[4]:.4f} ms, K1 {t[2]:.4f} / "
              f"{t[3]:.4f} ms ({(t[0] + t[5]) / (t[1] + t[4]):.2f}x the "
              f"first design's speed; 5 calls back to back, median of 10; "
              f"{card})", flush=True)

    # K16 on the tool's distribution
    library = library_calls(x)
    for mode in cheap_sin.MODES:
        name = f"cheap_sin_{mode}"
        got = cheap_sin.run(mode, x)
        ref = cheap_sin.run_plain(mode, x)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        err = float(diff.max())
        if mode == "copy":
            ok, limit = torch.equal(got, ref), "bit for bit"
        elif mode == "poly_bf16":
            ok = bool(torch.all(diff <= cheap_sin.bf16_ulp(ref)))
            limit = "1 bf16 ulp"
        else:
            ok, limit = err <= K16_TOL, f"{K16_TOL}"
        del got, ref, diff
        # the row's times, as every kernel's: one call per event pair (the
        # wrapper's host time and the call's included)
        k = cuda_ms(lambda: cheap_sin.run(mode, x))
        pl = cuda_ms(lambda: cheap_sin.run_plain(mode, x))
        lib = cuda_ms(library[mode])
        # on the device alone: the kernel and its call in turns (kernel,
        # call, call, kernel, twice), 5 calls back to back, the medians of
        # four
        turns = [back_to_back_ms(fn) for fn in
                 ((lambda: cheap_sin.run(mode, x)), library[mode],
                  library[mode], (lambda: cheap_sin.run(mode, x))) * 2]
        k_dev = statistics.median(turns[0::4] + turns[3::4])
        lib_dev = statistics.median(turns[1::4] + turns[2::4])
        b16, by16 = bound(0.0, 2 * nbytes(x), K16_OPS[mode] * x.numel())
        results[name].update(err=err, ms=k, plain_ms=pl, bound_ms=b16,
                             bound_by=by16, library_ms=lib)
        print(f"  K16 {mode}: max |err| {err:.6g} (limit {limit}), kernel "
              f"{k:.4f} ms, plain {pl:.4f} ms, one PyTorch call "
              f"({LIBRARY_CALLS[mode]}) {lib:.4f} ms (one call each, median "
              f"of 10); on the device, in turns, kernel {k_dev:.4f} ms, call "
              f"{lib_dev:.4f} ms: the kernel "
              f"{'at or under' if k_dev <= lib_dev else 'over'} it (5 calls "
              f"back to back, median of 10, the median of four); bound "
              f"{b16:.4f} ms ({by16}; {x.shape[0]} x 128 f32; {card})",
              flush=True)
        if not ok:
            raise RuntimeError(f"K16 {mode} disagrees with its plain version")
    return {"kernels": results, "launches": launches}


# ---- the tools' backward experiments (K17-K19) ------------------------------

# the unfolded field's products per row (K18, K19), on the IPE's 99 live
# columns: the forward recompute after the trunk (267 live head columns,
# the mid seed, the mid head's 3 columns), the dgrads (dhmid, dbottleneck,
# dh7, the trunk's), the weight gradients (w_out, w_emb, wh, the trunk's)
U_TAIL_MACS = 256 * 267 + 256 * 128 + 128 * 3
# K18 / K19 dg against their plain versions per ray: a mid_pre entry within
# this share of the sum of its terms' magnitudes may change sign with the
# order of the fp32 sums (a 256-term dot product and 5 adds: ~2^-20 of it
# for sums in a random order, 2^-16 at worst), and with it the whole
# row's contribution to its ray's dg; such rays (at most FLIP_SHARE of
# them) are left out of the comparison
MID_FLIP_TAU = 2.0 ** -20
FLIP_SHARE = 0.1
U_DGRAD_MACS = 128 * 3 + 128 * 256 + 267 * 256 + DGRAD_MACS
U_WGRAD_MACS = 128 * 3 + 256 * 128 + 256 * 267 + TRUNK_MACS
# the unfolded kernel B's products per row: the trunk's weight gradients
# (w0 and w4's x part on the IPE's 99 live columns), wh's 267 live columns,
# w_emb
U_KERNEL_B_MACS = IPE_DIM * 256 * 2 + 7 * 256 * 256 + 256 * 267 + 256 * 128
# K18's modes without weight gradients: the forward recomputed on the ring
RING_MODES = ("full", "no_ipe_bwd", "recompute")
BWD_EXP_FLOPS = {
    "bwd_ablate_full_wgrad": 2 * (TRUNK_MACS + U_TAIL_MACS + U_DGRAD_MACS
                                  + U_WGRAD_MACS),
    "bwd_ablate_full": 2 * (TRUNK_MACS + U_TAIL_MACS + U_DGRAD_MACS),
    "bwd_ablate_no_ipe_bwd": 2 * (TRUNK_MACS + U_TAIL_MACS + U_DGRAD_MACS),
    "bwd_ablate_recompute": 2 * (TRUNK_MACS + U_TAIL_MACS),
    # no trunk recompute, no layer-0 dgrad nor layer 4's x part
    "run_noipe": 2 * (U_TAIL_MACS + U_DGRAD_MACS - 2 * IPE_DIM * 256
                      + U_WGRAD_MACS),
}


def flip_free_rays(packed_v3, h7, g, bneck, S: int):
    """The rays whose every mid_pre entry stands further from zero than
    MID_FLIP_TAU of the sum of its terms' magnitudes (|bneck| |w_emb| +
    |b_mid| + the bands' |atten g|), mid_pre taken in float64 from the
    kernel's bottleneck `bneck`: on them the plain mask of mid_pre > 0 is
    the kernel's whatever the order of its fp32 sums -> (R,) bool."""
    import torch

    from rsn_torch.kernels import field_forward as ff

    wh, bh, w_emb, b_mid = packed_v3[16:20]
    col = slice(ff.OUT_ROUGH, ff.OUT_ROUGH + 1)
    rough = h7.double() @ wh[:, col].double() + bh[:, col].double()
    sp = torch.nn.functional.softplus(rough)
    m = bneck.double() @ w_emb.double() + b_mid.double()
    mag = bneck.double().abs() @ w_emb.double().abs() + b_mid.double().abs()
    for bi, k in enumerate(ff._BAND_KS):
        ag = torch.exp(-sp * k) * g[:, bi * 128:(bi + 1) * 128].double() \
            .repeat_interleave(S, 0)
        m, mag = m + ag, mag + ag.abs()
    near = (m.abs() <= MID_FLIP_TAU * mag).reshape(g.shape[0], -1)
    return ~near.any(dim=1)


def check_k17_against_k8(tag, args, first13, k17=None):
    """K17 against K8 on the same rows: dmc and the weight matrices w0..w7,
    w_hc bit for bit (kernel B sums K8's records), dg and the other 11
    gradients within K13_TOL of each tensor's max (kernel A's sums over
    128 rows run in another order); and against its first design (the
    build first13): dmc bit for bit, dg and the 20 gradients within
    K13_TOL -> K17's result."""
    import torch

    from rsn_torch.experiments import bwd_whole
    from rsn_torch.kernels import field_train as ft

    k17 = bwd_whole.field_backward_whole(*args) if k17 is None else k17
    k8 = ft.field_backward_v4(*args)
    torch.cuda.synchronize()
    rest = [i for i in range(20) if i not in K8_WEIGHTS]
    errs = {"dg": rel_err(k17[1], k8[1]),
            "the other 11": max(rel_err(k17[2][i], k8[2][i]) for i in rest)}
    same = torch.equal(k17[0], k8[0]) and all(
        torch.equal(k17[2][i], k8[2][i]) for i in K8_WEIGHTS)
    same_b = sum(torch.equal(k17[2][i], k8[2][i]) for i in rest)
    del k8
    old = bwd_whole.first_design(first13, *args)
    torch.cuda.synchronize()
    ferrs = {"dg": rel_err(k17[1], old[1]),
             "dpacked": max(rel_err(a, b) for a, b in zip(k17[2], old[2]))}
    fsame = torch.equal(k17[0], old[0])
    fdg = torch.equal(k17[1], old[1])
    del old
    print(f"  K17, {tag} ({args[1].shape[0]} rows): dmc, w0..w7 and w_hc "
          f"{'==' if same else '!='} K8's bit for bit ({same_b} of the other "
          f"11 too); dg and the other 11 within " + ", ".join(
              f"{k} {v:.6g}" for k, v in errs.items())
          + f" of K8's max; against its first design (RSN_K13_FIRST_DESIGN) "
          f"dmc {'==' if fsame else '!='} bit for bit, dg "
          f"{'==' if fdg else '!='} bit for bit, within " + ", ".join(
              f"{k} {v:.6g}" for k, v in ferrs.items())
          + f" (limit {K13_TOL})", flush=True)
    if not (same and fsame) or max(errs.values()) > K13_TOL \
            or max(ferrs.values()) > K13_TOL:
        raise RuntimeError(f"K17 disagrees with K8 or its first design "
                           f"({tag})")
    return k17


def whole_kernels_a_and_b(args):
    """The CUDA-event times of one K17 call's (its wrapper's arguments
    `args`) kernel A launches alone and of its kernel B launches alone (on
    the records kernel A left) -> (kernel A ms, kernel B ms, the plan, the
    scratch, which holds the last chunk's records)."""
    import torch

    from rsn_torch.experiments import bwd_whole
    from rsn_torch.kernels import field_train as ft
    from rsn_torch.kernels import wgrad_sm90 as wg
    from rsn_torch.kernels.build import load_library

    lib = load_library("field_train.cu")
    f_out, S = args[-2], args[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ft.stash_plan(f_out.shape[0] // S, S, sms)
    sc = bwd_whole.whole_scratch(plan, f_out.device)
    partial = torch.empty((plan.slices, wg.PARTIAL_FLOATS),
                          device=f_out.device)
    ka = cuda_ms(lambda: [bwd_whole.kernel_a(lib, plan, c, args[:-1], sc)
                          for c in plan.chunks])
    kb = cuda_ms(lambda: [
        wg.contract(sc.stash[:plan.blocks * (t1 - t0)], partial,
                    accumulate=i > 0, label=bwd_whole.WGRAD_LABEL)
        for i, (t0, t1) in enumerate(plan.chunks)])
    return ka, kb, plan, sc


def unfolded_kernels_a_and_b(name: str, inputs, S: int):
    """The CUDA-event times of one K18 full + wgrad or K19 call's (`name`
    and `inputs` as for bwd_ablate.kernel_a) kernel A
    launches alone and of its kernel B launches alone (on the records
    kernel A left) -> (kernel A ms, kernel B ms, the plan, the scratch,
    which holds the last chunk's records)."""
    import torch

    from rsn_torch.experiments import bwd_ablate
    from rsn_torch.kernels import wgrad_sm90 as wg
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments_bwd.cu")
    d_out = inputs[-1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bwd_ablate.stash_plan(d_out.shape[0] // S, S, sms,
                                 name != "run_noipe")
    sc = bwd_ablate.stash_scratch(plan, d_out.device)
    partial = torch.empty((plan.slices, wg.U_PARTIAL_FLOATS),
                          device=d_out.device)
    ka = cuda_ms(lambda: [bwd_ablate.kernel_a(lib, name, plan, c, inputs, sc)
                          for c in plan.chunks])
    kb = cuda_ms(lambda: [
        wg.contract(sc.stash[:plan.blocks * (t1 - t0)], partial, i > 0,
                    wg.UNFOLDED)
        for i, (t0, t1) in enumerate(plan.chunks)])
    return ka, kb, plan, sc


def library_unfolded_contraction(ws, want):
    """The unfolded kernel B's function in PyTorch calls: a chunk's records
    unpacked to row-major operands (not timed), then one torch.bmm over the
    six 256 x 256 layers (w1-w3, w5-w7) and torch.mm for w0, w4, wh's 272
    columns and w_emb, bf16 in, fp32 accumulate (fp32 out where this torch
    takes out_dtype, else bf16 out) -> (the five calls' CUDA-event ms,
    their largest error over each of `want`'s maxima, the output dtype)."""
    import torch

    from rsn_torch.kernels import wgrad_sm90 as wg

    rows = ws.shape[0] * wg.REC_ROWS
    feats = lambda off, f: wg._unswizzle(ws[:, off:off + f * wg.REC_ROWS],
                                         f).reshape(rows, f).contiguous()
    step = 256 * wg.REC_ROWS
    x = feats(wg.X_OFF, 128)
    hs = [feats(wg.ACT_OFF + i * step, 256) for i in range(8)]
    dpre = [feats(wg.DPRE_OFF + i * step, 256) for i in range(8)]
    dheads = feats(wg.U_DHEADS_OFF, wg.DHEADS_N)
    bneck = feats(wg.U_BNECK_OFF, 256)
    dmid = feats(wg.U_DMID_OFF, wg.MID_N)
    six = (1, 2, 3, 5, 6, 7)
    a6 = torch.stack([hs[i - 1] for i in six]).transpose(1, 2)
    b6 = torch.stack([dpre[i] for i in six])
    x4 = torch.cat([x, hs[3]], dim=1)
    try:
        torch.mm(x.t(), dpre[0], out_dtype=torch.float32)
        kw, how = {"out_dtype": torch.float32}, "fp32 out"
    except (TypeError, RuntimeError):
        kw, how = {}, "bf16 out"

    def five():
        return (torch.bmm(a6, b6, **kw), torch.mm(x.t(), dpre[0], **kw),
                torch.mm(x4.t(), dpre[4], **kw),
                torch.mm(hs[7].t(), dheads, **kw),
                torch.mm(bneck.t(), dmid, **kw))

    w6, w0, w4, wh, wemb = five()
    ms = cuda_ms(five)
    ws_ = {0: w0, 4: w4}
    ws_.update({i: w6[j] for j, i in enumerate(six)})
    errs = [rel_err(ws_[i], want[i]) for i in range(8)]
    errs.append(rel_err(wh, want[8][:, :wg.DHEADS_N]))
    errs.append(rel_err(wemb, want[9]))
    return ms, max(errs), how


def backward_experiments_phase(cam_calls, card, first, first13):
    """Phase 18 -> {"kernels": K17-K19's results, "launches": their
    launches in the run of this slice's path (the tools' backward
    experiments on the tools' rows; no model or CLI path calls them, as in
    rsn)}.  first: the build of experiments_bwd.cu with
    RSN_K18_FIRST_DESIGN, first13: of field_train.cu with
    RSN_K13_FIRST_DESIGN (phase 2)."""
    import torch

    from rsn_torch.experiments import bwd_ablate, bwd_noipe, bwd_whole
    from rsn_torch.experiments.interleave import tool_inputs
    from rsn_torch.kernels import field_forward as ff
    from rsn_torch.kernels import field_train as ft

    phase("phase 18: K17-K19 against plain versions at the tools' shapes")
    n, S = 131072, 128
    tfield, mc, g = tool_inputs(n, S)
    p3, p1 = ff.pack_params_v3(tfield), ff.pack_params_v3f(tfield)
    d_out = bwd_ablate.tool_cotangent(n, mc.device)
    d24 = d_out[:, :ft.OUT_TRAIN].contiguous()
    f_out = ft.field_forward_v3_train(p1, mc, g, S)
    _, xacts = ft.field_forward_v6(p1, mc, g, S, spill_x=True)
    k17_args = (p1, mc, g, d24, f_out, S)
    names = (("field_backward_whole", "field_backward_whole_wgrad")
             + tuple(bwd_ablate.label(*v) for v in bwd_ablate.VARIANTS)
             + (bwd_ablate.SPILL_LABEL, "run_noipe", "bwd_unfolded_wgrad"))
    ff.reset_launch_counts()
    k17 = bwd_whole.field_backward_whole(*k17_args)
    k18 = {bwd_ablate.label(*v): bwd_ablate.run(*v, p3, mc, g, d_out, S)
           for v in bwd_ablate.VARIANTS}
    k19 = bwd_noipe.run_noipe(p3, xacts, g, d_out, S)
    torch.cuda.synchronize()
    launches = {k: ff.LAUNCHES[k] for k in names}
    print(f"  launches in the path's run (the tools' backward experiments): "
          f"{launches}; the CLI runs launch none of them (no caller outside "
          f"the tools, as in rsn)")
    if min(launches.values()) <= 0:
        raise RuntimeError("a kernel of the backward experiments never "
                           "launched")
    # (wg below is each variant's use_wgrad flag)
    from rsn_torch.kernels import wgrad_sm90 as wgm

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = len(bwd_ablate.stash_plan(g.shape[0], S, sms).chunks)
    chunks17 = len(ft.stash_plan(g.shape[0], S, sms).chunks)
    per_chunk = {"bwd_ablate_full_wgrad": chunks, "run_noipe": chunks,
                 "bwd_unfolded_wgrad": 2 * chunks,
                 "field_backward_whole": chunks17,
                 "field_backward_whole_wgrad": chunks17}
    print(f"  K17, K18 full + wgrad and K19: kernel A and kernel B once per "
          f"chunk of each call ({chunks17} and {chunks} chunks): "
          f"{per_chunk}", flush=True)
    if any(launches[k] != v for k, v in per_chunk.items()):
        raise RuntimeError("K17, K18 full + wgrad or K19 did not run kernel "
                           "A and kernel B once per chunk")
    ring = {bwd_ablate.label(m, False): 1 for m in RING_MODES}
    ring[bwd_ablate.SPILL_LABEL] = 2
    print(f"  K18's modes without weight gradients: recompute one launch of "
          f"the ring forward, full and no_ipe_bwd kernel F (the ring's "
          f"trunk with K3's spill) and the body on its spill, one each: "
          f"{ring}", flush=True)
    if any(launches[k] != v for k, v in ring.items()):
        raise RuntimeError("K18's modes without weight gradients did not run "
                           "kernel F and the body once each")
    results = {k: {"err": 0.0} for k in names}

    def hold(tag, got, on_acts, plain, label, free=None):
        """got against the plain version fed the kernel's activations
        (ATOL; with `free`, its dg on those rays only, over dg's max) and,
        if given, the plain version that recomputes its trunk (K8_TOL) ->
        the largest error over each tensor's max against the latter (or
        the former)."""
        errs, note = {}, ""
        for ref_tag, ref in (("on the kernel's activations", on_acts),
                             ("recomputing its trunk", plain)):
            if ref is None:
                continue
            e = {}
            if got[0] is not None:
                e["dmc"] = rel_err(got[0], ref[0])
            e["dg"] = rel_err(got[1], ref[1])
            if free is not None and ref is on_acts:
                note = (f"; on the kernel's activations dg over all rays "
                        f"{e['dg']:.6g}")
                e["dg"] = float((got[1] - ref[1]).abs()[free].max()) / max(
                    float(ref[1].abs().max()), 1e-6)
            if got[2] is not None:
                e["dpacked"] = max(rel_err(a, b) for a, b in zip(got[2],
                                                                 ref[2]))
            errs[ref_tag] = e
        print(f"  {tag}: max error over each tensor's max against its plain "
              f"version " + "; ".join(f"{k}: " + ", ".join(
                  f"{n_} {v:.6g}" for n_, v in e.items())
                  for k, e in errs.items())
              + f" (limits {ATOL} and {K8_TOL}){note}", flush=True)
        first = max(errs["on the kernel's activations"].values())
        worst = max(errs.get("recomputing its trunk", {"": first}).values())
        if first > ATOL or worst > K8_TOL:
            raise RuntimeError(f"{tag} disagrees with its plain version")
        results[label]["err"] = worst

    # K17: its plain version is K8's
    hold("K17", k17, ft.field_backward_v5_plain(p1, mc, g, xacts, d24, f_out,
                                                S),
         ft.field_backward_v4_plain(*k17_args), "field_backward_whole")
    check_k17_against_k8("the tools' rows", k17_args, first13, k17)
    for p in (2, 4):
        check_k17_against_k8(f"phase 12's pass {p}", cam_calls["bwd"][p],
                             first13)
    del k17
    # K18's modes; K19 on K3's spill of the same rows.  The plain versions
    # on the kernels' activations take the kernels' bottleneck: K12's
    # heads product on the same activations (the same wmma sums, k
    # ascending, and bias add), and compare dg on the rays whose mid_pre
    # cannot change sign with the order of the fp32 sums
    hs, x = ft._split_acts(xacts), xacts[:, ft.ACTS_COLS:].contiguous()
    bneck = ff.field_forward(p3[:18], x)[:, ff.OUT_BOTTLENECK]
    free = flip_free_rays(p3, hs[-1], g, bneck, S)
    share = 1.0 - float(free.float().mean())
    print(f"  K18 / K19 dg per ray: {int((~free).sum())} of {free.numel()} "
          f"rays ({share:.4%}; limit {FLIP_SHARE:.0%}) hold a mid_pre entry "
          f"within {MID_FLIP_TAU:.3g} of its terms' magnitudes of zero and "
          f"are left out; the plain versions take K12's bottleneck",
          flush=True)
    if share > FLIP_SHARE:
        raise RuntimeError("too many rays near a mid_pre sign change")
    for mode, wg in bwd_ablate.VARIANTS:
        label = bwd_ablate.label(mode, wg)
        hold(f"K18 {mode}{'+wgrad' if wg else ''}", k18[label],
             bwd_ablate.backward_from_acts(p3, hs, x, g, d_out, S, mode, wg,
                                           mc, bneck),
             bwd_ablate.bwd_ablate_plain(p3, mc, g, d_out, S, mode, wg),
             label, free)
        torch.cuda.empty_cache()
    full, nowg = k18["bwd_ablate_full_wgrad"], k18["bwd_ablate_full"]
    if not (torch.equal(full[0], nowg[0]) and torch.equal(full[1], nowg[1])):
        raise RuntimeError("K18 full: dmc or dg depend on the weight "
                           "gradients")
    hold("K19", (None,) + k19, (None,) + bwd_noipe.run_noipe_plain(
        p3, xacts, g, d_out, S, bneck), None, "run_noipe", free)
    del bneck, free
    same = torch.equal(k19[0], full[1]) and all(
        torch.equal(a, b) for a, b in zip(k19[1], full[2]))
    print(f"  K19 on K3's spill {'==' if same else '!='} K18's full mode (dg "
          f"and the 22 weight gradients), bit for bit; K18 full's dmc and dg "
          f"== without the weight gradients", flush=True)
    if not same:
        raise RuntimeError("K19 differs from K18's full mode")
    # the two-phase design against its first design, the same rows
    k18_in, k19_in = (p3, mc, g, d_out), (p3, g, xacts, d_out)
    for tag, label, got, inputs in (
            ("K18 full + wgrad", "bwd_ablate_full_wgrad", full, k18_in),
            ("K19", "run_noipe", (None,) + k19, k19_in)):
        old = bwd_ablate.first_design(first, label, inputs, S)
        torch.cuda.synchronize()
        same = (got[0] is None or torch.equal(got[0], old[0])) and \
            torch.equal(got[1], old[1])
        werr = max(rel_err(a, b) for a, b in zip(got[2], old[2]))
        outs = "dg" if got[0] is None else "dmc and dg"
        print(f"  {tag} (kernel A + kernel B) against its first design "
              f"(RSN_K18_FIRST_DESIGN): {outs} "
              f"{'==' if same else '!='} bit for bit; the 22 gradients "
              f"within {werr:.6g} of each max (limit {K13_TOL})", flush=True)
        if not same or werr > K13_TOL:
            raise RuntimeError(f"{tag} disagrees with its first design")
        del old
    # the modes without weight gradients (the ring's route) against their
    # first design, which recomputes the IPE and the trunk per 64-row tile
    for mode in RING_MODES:
        label = bwd_ablate.label(mode, False)
        got = k18[label]
        old = bwd_ablate.first_design(first, label, k18_in, S)
        torch.cuda.synchronize()
        same = torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
        how = ("one launch of the ring forward" if mode == "recompute" else
               "kernel F + the body on its spill")
        differ = (int((got[0] != old[0]).sum()),
                  int((got[1] != old[1]).sum()))
        print(f"  K18 {mode} ({how}) against its first design "
              f"(RSN_K18_FIRST_DESIGN): dmc and dg "
              f"{'==' if same else '!='} bit for bit ({differ[0]} dmc and "
              f"{differ[1]} dg values differ)", flush=True)
        if not same:
            raise RuntimeError(f"K18 {mode} differs from its first design")
        del old
    del k18, k19, full, nowg
    # kernel F: its spill == K3's spill_x of the same rows, bit for bit
    from rsn_torch.kernels.build import load_library

    lib = load_library("experiments_bwd.cu")
    spill = torch.empty_like(xacts)
    bwd_ablate.spill_kernel(lib, p3, mc, spill)
    torch.cuda.synchronize()
    same = torch.equal(spill, xacts)
    err = rel_err(spill, bwd_ablate.spill_plain(p3, mc))
    print(f"  K18's kernel F: its spill {'==' if same else '!='} K3's "
          f"(field_forward_v6, spill_x) bit for bit; within {err:.6g} of "
          f"its plain version's max (limit {ATOL})", flush=True)
    if not same or err > ATOL:
        raise RuntimeError("K18's kernel F disagrees with K3's spill or its "
                           "plain version")
    results[bwd_ablate.SPILL_LABEL]["err"] = err
    torch.cuda.empty_cache()

    # times and bounds
    w1, w3 = nbytes(*p1), nbytes(*p3)
    dg_bytes = g.shape[0] * 512 * 4
    # K17: one call beside its first design's, then back to back in turns
    # with it (new, first, new, first); kernels A and B apart; each
    # design's scratch; kernel B alone on the last chunk
    ms = {"K8": cuda_ms(lambda: ft.field_backward_v4(*k17_args))}
    new = lambda: bwd_whole.field_backward_whole(*k17_args)
    old = lambda: bwd_whole.first_design(first13, *k17_args)
    k, kold = cuda_ms(new), cuda_ms(old)
    turns = [back_to_back_ms(f) for f in (new, old, new, old)]
    pl = cuda_ms(lambda: ft.field_backward_v4_plain(*k17_args))
    b, by = bound(FLOPS["field_backward_v4"] * n,
                  nbytes(mc, g, d24, f_out) + w1 + dg_bytes
                  + ft.PACK_FLOATS * 4 + n * 16 * 4)
    results["field_backward_whole"].update(ms=k, plain_ms=pl, bound_ms=b,
                                           bound_by=by)
    ka, kb, plan, sc = whole_kernels_a_and_b(k17_args)
    print(f"  K17: {n} rows, one call {k:.4f} ms against the first design's "
          f"{kold:.4f} ms; back to back in turns {turns[0]:.4f} / "
          f"{turns[2]:.4f} ms against {turns[1]:.4f} / {turns[3]:.4f} ms "
          f"({(turns[1] + turns[3]) / (turns[0] + turns[2]):.2f}x); kernel A "
          f"alone {ka:.4f} ms, kernel B alone {kb:.4f} ms over "
          f"{len(plan.chunks)} chunks of {plan.blocks} blocks x up to "
          f"{plan.chunks[0][1] - plan.chunks[0][0]} tiles, P = "
          f"{plan.slices}; K8 {ms['K8']:.4f} ms (the same call), plain "
          f"{pl:.4f} ms, bound {b:.4f} ms ({by}); scratch per call "
          f"{bwd_whole.scratch_bytes(plan)} bytes (the first design's: "
          f"{bwd_whole.first_design_scratch_bytes(plan)}) (median of 10; "
          f"{card})", flush=True)
    t0, t1 = plan.chunks[-1]
    results["field_backward_whole_wgrad"].update(kernel_b_on_a_chunk(
        sc.stash[:plan.blocks * (t1 - t0)], bwd_whole.WGRAD_LABEL, card,
        "K17's last chunk of the tools' rows"))
    del sc
    torch.cuda.empty_cache()
    for mode, wg in bwd_ablate.VARIANTS:
        label = bwd_ablate.label(mode, wg)
        k = cuda_ms(lambda: bwd_ablate.run(mode, wg, p3, mc, g, d_out, S))
        pl = cuda_ms(lambda: bwd_ablate.bwd_ablate_plain(p3, mc, g, d_out, S,
                                                         mode, wg))
        b, by = bound(BWD_EXP_FLOPS[label] * n,
                      nbytes(mc, g, d_out) + w3 + dg_bytes + n * 16 * 4
                      + (bwd_ablate.PACK_FLOATS * 4 if wg else 0))
        results[label].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
        print(f"  K18 {mode}{'+wgrad' if wg else ''}: {n} rows, kernel "
              f"{k:.4f} ms, plain {pl:.4f} ms, bound {b:.4f} ms ({by}; "
              f"median of 10; {card})", flush=True)
        torch.cuda.empty_cache()
    kf = cuda_ms(lambda: bwd_ablate.spill_kernel(lib, p3, mc, spill))
    pl = cuda_ms(lambda: bwd_ablate.spill_plain(p3, mc))
    b, by = bound(2 * TRUNK_MACS * n, nbytes(mc, *p3[:16], spill))
    results[bwd_ablate.SPILL_LABEL].update(ms=kf, plain_ms=pl, bound_ms=b,
                                           bound_by=by)
    print(f"  K18's kernel F: {n} rows, kernel {kf:.4f} ms, plain {pl:.4f} "
          f"ms, bound {b:.4f} ms ({by}; median of 10; {card})", flush=True)
    # the three modes beside their first design: one call each, back to
    # back in turns (design, first, design, first), kernel F and the body
    # apart, each call's scratch
    R = g.shape[0]
    first_scratch = bwd_ablate.first_design_scratch_bytes(R, mc.device)
    for mode in RING_MODES:
        label = bwd_ablate.label(mode, False)
        fn = lambda: bwd_ablate.run(mode, False, p3, mc, g, d_out, S)
        old = lambda: bwd_ablate.first_design(first, label, k18_in, S)
        one = (cuda_ms(fn), cuda_ms(old))
        turns = [back_to_back_ms(f) for f in (fn, old, fn, old)]
        line = (f"  K18 {mode}: {n} rows, one call {one[0]:.4f} ms against "
                f"the first design's {one[1]:.4f} ms; back to back in turns "
                f"{turns[0]:.4f} / {turns[2]:.4f} ms against {turns[1]:.4f} "
                f"/ {turns[3]:.4f} ms "
                f"({(turns[1] + turns[3]) / (turns[0] + turns[2]):.2f}x)")
        if mode == "recompute":
            line += (f"; one launch; scratch 0 bytes (the first design's "
                     f"{first_scratch} of recompute slots)")
        else:
            dmc_ = torch.empty((n, ff.IN_COLS), device=mc.device)
            dg_ = torch.zeros((R, 512), device=mc.device)
            body = cuda_ms(lambda: bwd_ablate.body_kernel(
                lib, mode, p3, mc, g, spill, d_out, S, dmc_, dg_))
            line += (f"; kernel F alone {kf:.4f} ms, the body alone "
                     f"{body:.4f} ms; scratch "
                     f"{bwd_ablate.spill_scratch_bytes(n)} bytes of "
                     f"spill (the first design's {first_scratch} of "
                     f"recompute slots)")
            del dmc_, dg_
        print(line + f" (median of 10; {card})", flush=True)
        torch.cuda.empty_cache()
    del spill
    out, acts = ft.field_forward_v6(p1, mc, g, S)
    k4 = cuda_ms(lambda: ft.field_backward_v5(p1, mc, g, acts, d24, out, S))
    del acts
    k = cuda_ms(lambda: bwd_noipe.run_noipe(p3, xacts, g, d_out, S))
    pl = cuda_ms(lambda: bwd_noipe.run_noipe_plain(p3, xacts, g, d_out, S))
    b, by = bound(BWD_EXP_FLOPS["run_noipe"] * n,
                  nbytes(xacts, g, d_out) + w3 + dg_bytes
                  + bwd_ablate.PACK_FLOATS * 4)
    results["run_noipe"].update(ms=k, plain_ms=pl, bound_ms=b, bound_by=by)
    print(f"  K19: {n} rows, kernel {k:.4f} ms, K4 on K3's spill {k4:.4f} ms "
          f"(the same call), plain {pl:.4f} ms, bound {b:.4f} ms ({by}; "
          f"median of 10; {card})", flush=True)

    # K18 full + wgrad and K19 beside their first design: one call each,
    # back to back in turns (design, first, design, first), kernel A and
    # kernel B apart; each call's scratch
    for tag, label, fn, inputs in (
            ("K18 full + wgrad", "bwd_ablate_full_wgrad",
             lambda: bwd_ablate.run("full", True, p3, mc, g, d_out, S),
             (p3, mc, g, d_out)),
            ("K19", "run_noipe",
             lambda: bwd_noipe.run_noipe(p3, xacts, g, d_out, S),
             (p3, g, xacts, d_out))):
        old = lambda: bwd_ablate.first_design(first, label, inputs, S)
        one = (cuda_ms(fn), cuda_ms(old))
        turns = [back_to_back_ms(f) for f in (fn, old, fn, old)]
        ka, kb, plan, sc = unfolded_kernels_a_and_b(label, inputs, S)
        del sc
        print(f"  {tag}: {n} rows, one call {one[0]:.4f} ms against the "
              f"first design's {one[1]:.4f} ms; back to back in turns "
              f"{turns[0]:.4f} / {turns[2]:.4f} ms against {turns[1]:.4f} / "
              f"{turns[3]:.4f} ms ({turns[1] / turns[0]:.2f}x); kernel A "
              f"alone {ka:.4f} ms, kernel B alone {kb:.4f} ms over "
              f"{len(plan.chunks)} chunks of {plan.blocks} blocks x up to "
              f"{plan.chunks[0][1] - plan.chunks[0][0]} tiles, P = "
              f"{plan.slices}; scratch {bwd_ablate.scratch_bytes(plan)} "
              f"bytes (median of 10; {card})", flush=True)
        torch.cuda.empty_cache()

    # kernel B alone on the records K18's kernel A leaves of its last chunk,
    # against its plain contraction, and PyTorch's calls on the same operands
    plan = bwd_ablate.stash_plan(g.shape[0], S, sms)
    sc = bwd_ablate.stash_scratch(plan, mc.device)
    ws = [bwd_ablate.kernel_a(lib, "bwd_ablate_full_wgrad", plan, c,
                              (p3, mc, g, d_out), sc)
          for c in plan.chunks][-1]
    got = torch.empty((plan.slices, wgm.U_PARTIAL_FLOATS), device=ws.device)
    ref = torch.empty_like(got)
    wgm.contract(ws, got, False, wgm.UNFOLDED)
    wgm.contract_plain(ws, ref, False, wgm.UNFOLDED)
    torch.cuda.synchronize()
    err = max(rel_err(a, r) for a, r in zip(wgm.unfolded_weight_grads(got),
                                            wgm.unfolded_weight_grads(ref)))
    k = cuda_ms(lambda: wgm.contract(ws, got, False, wgm.UNFOLDED))
    pl = cuda_ms(lambda: wgm.contract_plain(ws, ref, False, wgm.UNFOLDED))
    lib_ms, lib_err, how = library_unfolded_contraction(
        ws, wgm.unfolded_weight_grads(got))
    b, by = bound(2 * U_KERNEL_B_MACS * ws.shape[0] * wgm.REC_ROWS,
                  nbytes(ws, got))
    print(f"  their kernel B on K18's last chunk ({ws.shape[0]} records, "
          f"{ws.shape[0] * wgm.REC_ROWS} rows, P = {plan.slices}): within "
          f"{err:.6g} of its plain fp32 contraction (limit {K13_TOL}); "
          f"kernel {k:.4f} ms, plain {pl:.4f} ms, PyTorch {lib_ms:.4f} ms "
          f"(5 calls, {how}; within {lib_err:.6g} of kernel B), bound "
          f"{b:.4f} ms ({by}; median of 10; {card})", flush=True)
    if err > K13_TOL:
        raise RuntimeError("the unfolded kernel B disagrees with its plain "
                           "version")
    results["bwd_unfolded_wgrad"].update(err=err, ms=k, plain_ms=pl,
                                         bound_ms=b, bound_by=by,
                                         library_ms=lib_ms)
    return {"kernels": results, "launches": launches}


if __name__ == "__main__":
    sys.exit(main())
