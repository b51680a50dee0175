"""The train loop and the chunked full-image render (port of
rsn.engine.trainer).

One training step: uniform pixel sampling and ray generation on the
device, the 4-pass training forward (the fused kernels with bf16), the
loss dict with the 50-step warmup of the normal and orientation losses,
backward, RAdam on the field.  With model.use_proposal (the
reflect-sampling-nerf-proposal preset) the proposal field runs passes 1
and 3, trains on the interlevel loss with Adam (the "proposal_networks"
group), and its sampling histogram is annealed.  The camera optimizer, a
mesh of several devices and the eval hooks (steps_per_eval_batch /
steps_per_eval_image) are later steps of the port (ROADMAP.md).
steps_per_dispatch is read as 1: one step per loop iteration (a CUDA
graph of several steps is later work).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rsn_torch.configs import TrainerConfig, loss_coefficients_at_step
from rsn_torch.core.rays import RayBundle
from rsn_torch.data.cameras import Cameras, generate_image_rays, generate_rays
from rsn_torch.data.synthetic import load_dataset
from rsn_torch.engine import checkpoints as ckpt_lib
from rsn_torch.engine.optimizers import build_field_optimizer, build_optimizer
from rsn_torch.models import model as model_lib
from rsn_torch.models.field import Field
from rsn_torch.models.proposal import ProposalField

# Adaptive eval compaction: renders start at the remembered bucket and
# re-render at a larger one whenever a chunk drops a masked ray, so the
# image always equals fraction 1.0; the next bucket tracks the worst
# chunk's mask fraction plus REFLECT_HEADROOM.
REFLECT_FRACTION_BUCKETS = (0.25, 0.375, 0.5, 0.625, 0.75, 1.0)
REFLECT_HEADROOM = 0.1
# controller cadence when logging is off (steps_per_log <= 0): the
# controller keeps running
REFLECT_ADAPT_FALLBACK_CADENCE = 100


def preferred_eval_chunk(config: TrainerConfig, device) -> int:
    """Rays per chunk for offline render: the reference's 1024 is a
    viewer memory knob; on a CUDA card the kernels want >= 16384 rays in
    flight.  Results do not depend on the chunk size."""
    chunk = config.pipeline.model.eval_num_rays_per_chunk
    if torch.device(device).type == "cuda":
        chunk = max(chunk, 16384)
    return chunk


def render_image(field: Field, cameras: Cameras, camera_index: int,
                 config: TrainerConfig,
                 rays_per_chunk: Optional[int] = None,
                 product_only: bool = False, mesh=None,
                 reflect_memo: Optional[Dict] = None,
                 proposal: Optional[ProposalField] = None
                 ) -> Dict[str, np.ndarray]:
    """Render camera `camera_index` chunk by chunk on the cameras' device
    -> {name: (H, W, C) numpy}.  proposal: the run's proposal field (the
    preset), else None.

    product_only: the caller consumes only final_rgb, accumulation and
    depth (orbit / path renders): passes 1 and 3 run density-only.
    reflect_memo: a dict the caller keeps across renders; it remembers
    the compaction bucket per (model config, chunk size).  The result
    also carries "mask", the rays that took the reflected passes."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device render: ROADMAP Queue 1 step 13 is not ported")
    mcfg = config.pipeline.model
    chunk = rays_per_chunk or mcfg.eval_num_rays_per_chunk
    H, W = cameras.height, cameras.width
    origins, dirs, pixel_area = generate_image_rays(cameras, camera_index)
    total = H * W
    starts = range(0, total, chunk)

    if product_only:
        keep = ("mid_rgb_fine", "mid_reflect_fine", "accumulation_fine",
                "depth_fine")
    else:
        keep = ("mid_rgb_coarse", "mid_rgb_fine", "mid_reflect_coarse",
                "mid_reflect_fine", "accumulation_coarse",
                "accumulation_fine", "depth_coarse", "depth_fine",
                "roughness")

    # one packing of the kernels' weights for every chunk and re-render
    packed = model_lib.pack_kernel_operands(field, mcfg, proposal)

    def render_all(mcfg_b):
        parts, masks, overflows = {}, [], []
        for s in starts:
            sl = slice(s, min(s + chunk, total))
            zeros = torch.zeros_like(pixel_area[sl])
            rb = RayBundle(origins=origins[sl], directions=dirs[sl],
                           pixel_area=pixel_area[sl], nears=zeros,
                           fars=zeros)
            rb = model_lib.apply_collider(rb, mcfg_b)
            out = model_lib.get_outputs(field, rb, mcfg_b,
                                        need_coarse_rgb=not product_only,
                                        packed=packed, proposal=proposal)
            for k in keep:
                if k in out:
                    parts.setdefault(k, []).append(out[k])
            if "mid_reflect_fine" in out:
                masks.append(out["mask"])
                overflows.append(out["reflect_overflow"])
        overflow = bool(overflows) and bool(torch.stack(overflows).amax() > 0)
        return parts, masks, overflow

    adaptive = (mcfg.adaptive_eval_reflect_fraction and mcfg.use_reflection
                and mcfg.eval_reflect_ray_fraction >= 1.0)
    memo = {} if reflect_memo is None else reflect_memo
    memo_key = (mcfg, chunk)
    frac = memo.get(memo_key, 1.0) if adaptive else 1.0
    while True:
        mcfg_b = (mcfg if frac >= 1.0 else dataclasses.replace(
            mcfg, eval_reflect_ray_fraction=frac))
        parts, masks, overflow = render_all(mcfg_b)
        if not adaptive or not masks:
            break
        worst = torch.stack([m.float().mean() for m in masks]).amax()
        need = min(1.0, float(worst) + REFLECT_HEADROOM)
        if frac < 1.0 and overflow:
            # straight to the bucket the observed mask needs (one re-render)
            frac = next(b for b in REFLECT_FRACTION_BUCKETS
                        if b > frac and b >= need)
            continue
        memo[memo_key] = next(b for b in REFLECT_FRACTION_BUCKETS
                              if b >= need)
        break

    result = {k: torch.cat(v).reshape(H, W, -1).float().cpu().numpy()
              for k, v in parts.items()}
    if masks:
        result["mask"] = torch.cat(masks).reshape(H, W, 1).cpu().numpy()
    return result


# ---- training ------------------------------------------------------------

def sample_pixel_batch(images: torch.Tensor, cameras: Cameras,
                       num_rays: int, generator: torch.Generator
                       ) -> Tuple[RayBundle, torch.Tensor]:
    """Uniform pixel sampling + ray generation on the images' device:
    -> (ray bundle, (num_rays, C) ground truth in [0, 1])."""
    n, h, w = images.shape[:3]
    dev = images.device
    ci = torch.randint(0, n, (num_rays,), generator=generator, device=dev)
    py = torch.randint(0, h, (num_rays,), generator=generator, device=dev)
    px = torch.randint(0, w, (num_rays,), generator=generator, device=dev)
    origins, dirs, pixel_area = generate_rays(cameras, ci, py, px)
    gt = images[ci, py, px].float()
    if images.dtype == torch.uint8:
        gt = gt / 255.0
    zeros = torch.zeros((num_rays, 1), device=dev)
    bundle = RayBundle(origins=origins, directions=dirs,
                       pixel_area=pixel_area, nears=zeros, fars=zeros,
                       camera_indices=ci[:, None])
    return bundle, gt


def loss_coefficients(mcfg, step: int) -> Dict[str, float]:
    """The loss coefficients at `step`: the warmup schedule, plus the
    interlevel and distortion multipliers in proposal mode."""
    coeffs = loss_coefficients_at_step(step)
    if mcfg.use_proposal:
        coeffs["interlevel_loss"] = mcfg.interlevel_loss_mult
        if mcfg.distortion_loss_mult:
            coeffs["distortion_loss"] = mcfg.distortion_loss_mult
    return coeffs


def proposal_anneal(mcfg, step: int) -> Optional[float]:
    """mip-NeRF-360's weight-anneal exponent at `step`,
    s f / ((s - 1) f + 1) with f = clip(step / N, 0, 1), in float32 as rsn
    traces it; None when off (no proposal, or N = 0)."""
    n = mcfg.proposal_weights_anneal_max_num_iters
    if not (mcfg.use_proposal and n):
        return None
    f32 = np.float32
    frac = f32(min(max(f32(step) / f32(n), f32(0.0)), f32(1.0)))
    s = f32(mcfg.proposal_weights_anneal_slope)
    return float(f32((s * frac) / ((s - f32(1.0)) * frac + f32(1.0))))


def _check_slice(config: TrainerConfig) -> None:
    """Raise on what the training slice of the port leaves out."""
    dm, mcfg = config.pipeline.datamanager, config.pipeline.model
    if dm.camera_optimizer != "off":
        raise NotImplementedError(
            f"camera_optimizer={dm.camera_optimizer!r}: ROADMAP Queue 1 "
            "step 8 (camera-optimizer path, kernels K7/K8) is not ported")
    if config.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={config.num_devices}: ROADMAP Queue 1 step 13 "
            "(data-parallel mesh) is not ported")
    if config.profile_dir:
        raise NotImplementedError(
            "profile_dir: ROADMAP Queue 1 step 7 (the trainer's profiler "
            "window) is not ported")
    if (mcfg.compute_dtype == "bfloat16" and mcfg.use_pallas
            and mcfg.use_pallas_train and not mcfg.use_pallas_acts):
        raise NotImplementedError(
            "use_pallas_acts=False (the recompute backward, kernels K7/K8): "
            "ROADMAP Queue 1 step 8 is not ported")


class Trainer:
    """Run dir, config.json and train_log.jsonl; one training step per
    loop iteration; the adaptive reflect-fraction controller; checkpoints
    every steps_per_save steps and at the end; restore."""

    def __init__(self, config: TrainerConfig, run_dir: Optional[str] = None,
                 device="cuda"):
        _check_slice(config)
        self.config = config
        self.device = torch.device(device)
        dm = config.pipeline.datamanager
        self.train_ds = load_dataset(dm.dataparser, dm.data or "", "train",
                                     dm.downscale_factor, dm.scale_factor)
        if run_dir is None:
            ts = time.strftime("%Y-%m-%d_%H%M%S", time.localtime())
            run_dir = os.path.join(config.output_dir, config.experiment_name,
                                   config.method_name, ts)
        self.run_dir = run_dir
        self.ckpt_dir = os.path.join(run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        ckpt_lib.dump_config(run_dir, config)

        self.field = Field(torch.Generator().manual_seed(config.seed)).to(
            self.device)
        self.optimizer, self.scheduler = build_field_optimizer(
            self.field, config.optimizers)
        self.proposal = self.prop_optimizer = self.prop_scheduler = None
        if config.pipeline.model.use_proposal:
            self.proposal = ProposalField(
                torch.Generator().manual_seed(config.seed + 2)).to(self.device)
            self.prop_optimizer, self.prop_scheduler = build_optimizer(
                self.proposal.parameters(),
                config.optimizers["proposal_networks"])
        self.images = torch.as_tensor(self.train_ds.images).to(self.device)
        self.cameras = self.train_ds.cameras.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed)
        self.step = 0
        self._reflect_frac = config.pipeline.model.reflect_ray_fraction
        self._reflect_down_votes = 0
        self._adapt_cadence = (config.steps_per_log
                               if config.steps_per_log > 0
                               else REFLECT_ADAPT_FALLBACK_CADENCE)
        self._log_file = open(os.path.join(run_dir, "train_log.jsonl"), "a")

    # ---- one step ----

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One optimizer step -> this step's losses and telemetry, as
        device scalars (no host sync)."""
        cfg = self.config
        mcfg = cfg.pipeline.model
        if self._reflect_frac != mcfg.reflect_ray_fraction:
            mcfg = dataclasses.replace(mcfg,
                                       reflect_ray_fraction=self._reflect_frac)
        bundle, gt = sample_pixel_batch(
            self.images, self.cameras,
            cfg.pipeline.datamanager.train_num_rays_per_batch,
            self.generator)
        bundle = model_lib.apply_collider(bundle, mcfg)
        # rays are autograd leaves (no camera optimizer): the primary
        # passes' backward skips the dead IPE backward
        outputs = model_lib.get_outputs(
            self.field, bundle, mcfg, training=True,
            generator=self.generator, rays_live=False,
            proposal=self.proposal,
            prop_anneal=proposal_anneal(mcfg, self.step))
        # the warmup (rsn's loss_coefficients_traced): the normal and
        # orientation losses are zero before WARMUP_STEPS
        loss_dict = model_lib.get_loss_dict(
            outputs, gt, loss_coefficients(mcfg, self.step))
        total = sum(loss_dict.values())
        groups = [(self.optimizer, self.scheduler)]
        if self.proposal is not None:
            groups.append((self.prop_optimizer, self.prop_scheduler))
        for opt, _ in groups:
            opt.zero_grad(set_to_none=True)
        total.backward()
        for opt, sched in groups:
            opt.step()
            sched.step()
        self.step += 1
        return dict({k: v.detach() for k, v in loss_dict.items()},
                    total_loss=total.detach(),
                    mask_fraction=outputs["mask"].float().mean(),
                    reflect_overflow=outputs["reflect_overflow"])

    # ---- the adaptive reflect-fraction controller (rsn trainer) ----

    def _maybe_adapt_reflect_fraction(self, metrics: Dict[str, float]) -> None:
        """Raise the reflect_ray_fraction bucket when the mask fraction
        approaches the cap, and at once when masked rays overflowed;
        relax it toward the configured floor after 3 under-target
        observations in a row.  Never below the configured fraction."""
        if not self.config.adaptive_reflect_fraction:
            return
        floor = self.config.pipeline.model.reflect_ray_fraction
        cur = self._reflect_frac
        need = min(1.0, metrics["mask_fraction"] + REFLECT_HEADROOM)
        target = max(next(b for b in REFLECT_FRACTION_BUCKETS if b >= need),
                     floor)
        if metrics["reflect_overflow"] > 0.0 and cur < 1.0:
            target = max(target, next(b for b in REFLECT_FRACTION_BUCKETS
                                      if b > cur))
        if target > cur:
            self._reflect_down_votes = 0
            self._set_reflect_fraction(target)
        elif target < cur:
            self._reflect_down_votes += 1
            if self._reflect_down_votes >= 3:
                self._reflect_down_votes = 0
                self._set_reflect_fraction(target)
        else:
            self._reflect_down_votes = 0

    def _set_reflect_fraction(self, frac: float) -> None:
        print(f"reflect compaction: fraction -> {frac:g}", flush=True)
        self._reflect_frac = frac

    # ---- checkpoints ----

    def save(self) -> str:
        return ckpt_lib.save_checkpoint(
            self.ckpt_dir, self.step, self.field, self.optimizer,
            self.scheduler, {"reflect_fraction": self._reflect_frac,
                             "reflect_down_votes": self._reflect_down_votes,
                             "generator": self.generator.get_state()},
            proposal=self.proposal, proposal_optimizer=self.prop_optimizer,
            proposal_scheduler=self.prop_scheduler)

    def restore(self, load_dir: str) -> None:
        """Resume from the latest checkpoint under load_dir (a run's
        checkpoints directory): field, optimizer, schedule, step, the
        controller state, and the proposal field with its optimizer and
        schedule."""
        path = ckpt_lib.latest_checkpoint(load_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {load_dir}")
        state = ckpt_lib.load_checkpoint(path)
        self.field.load_state_dict(state["field"])
        self.step = int(state["step"])
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        if "scheduler" in state:
            self.scheduler.load_state_dict(state["scheduler"])
        if self.proposal is not None:
            self.proposal.load_state_dict(state["proposal"])
            if "proposal_optimizer" in state:
                self.prop_optimizer.load_state_dict(
                    state["proposal_optimizer"])
            if "proposal_scheduler" in state:
                self.prop_scheduler.load_state_dict(
                    state["proposal_scheduler"])
        trainer = state.get("trainer", {})
        floor = self.config.pipeline.model.reflect_ray_fraction
        self._reflect_frac = max(float(trainer.get("reflect_fraction",
                                                   floor)), floor)
        self._reflect_down_votes = int(trainer.get("reflect_down_votes", 0))
        if "generator" in trainer:
            self.generator.set_state(trainer["generator"])

    # ---- the loop ----

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        self._log_file.write(json.dumps({"step": step, **metrics}) + "\n")
        self._log_file.flush()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Train to max_steps (default max_num_iterations); each log line
        has the step, the losses, the mask fraction, the reflect bucket
        and the rays/s since the previous log line."""
        cfg = self.config
        max_steps = max_steps or cfg.max_num_iterations
        num_rays = cfg.pipeline.datamanager.train_num_rays_per_batch
        hit = lambda c: c > 0 and self.step % c == 0
        last: Dict[str, float] = {}
        self._sync()
        t0, step0 = time.perf_counter(), self.step
        first = True
        while self.step < max_steps:
            metrics = self.train_step()
            adapt_now = (cfg.adaptive_reflect_fraction
                         and hit(self._adapt_cadence))
            log_now = hit(cfg.steps_per_log) or first
            if cfg.debug_nans or adapt_now or log_now:
                values = {k: float(v) for k, v in metrics.items()}
                if cfg.debug_nans and not math.isfinite(values["total_loss"]):
                    raise FloatingPointError(
                        f"step {self.step}: non-finite loss {values}")
            if log_now:
                first = False
                self._sync()
                t1 = time.perf_counter()
                rays_s = (self.step - step0) * num_rays / (t1 - t0)
                line = dict(values, reflect_fraction=self._reflect_frac,
                            rays_per_sec=rays_s)
                self._log(self.step, line)
                losses = " ".join(f"{k}={values[k]:.6g}"
                                  for k in sorted(values)
                                  if k.startswith(("loss", "predicted",
                                                   "orientation",
                                                   "interlevel",
                                                   "distortion")))
                print(f"step {self.step}: loss={values['total_loss']:.6g} "
                      f"{losses} mask fraction "
                      f"{values['mask_fraction']:.4f}, reflect bucket "
                      f"{self._reflect_frac:g}, {rays_s:.1f} rays/s",
                      flush=True)
                last = line
                t0, step0 = time.perf_counter(), self.step
            if adapt_now:  # fixed cadence, never the first log
                self._maybe_adapt_reflect_fraction(values)
            if hit(cfg.steps_per_save) or self.step == max_steps:
                self.save()
        return last
