"""The train loop and the chunked full-image render (port of
rsn.engine.trainer).

One training step: uniform pixel sampling and ray generation on the
device, the 4-pass training forward (the fused kernels with bf16), the
loss dict with the 50-step warmup of the normal and orientation losses,
backward, RAdam on the field.  With model.use_proposal (the
reflect-sampling-nerf-proposal preset) the proposal field runs passes 1
and 3, trains on the interlevel loss with Adam (the "proposal_networks"
group), and its sampling histogram is annealed.  With
datamanager.camera_optimizer "SO3xR3" one pose delta per training camera
moves the sampled rays before the model (rsn_torch.models.camera_opt) and
trains with Adam (the "camera_opt" group) on the photometric losses and
its regularizer alone, while the field sees every loss: two backward
passes over one graph, as rsn takes two VJPs.

The eval hooks run at rsn's cadences, on the eval split ("val" for
blender, "test" otherwise, the train split where the eval split has no
files): every steps_per_eval_batch steps the eval-mode loss and PSNR of
eval_num_rays_per_batch pixels drawn from a generator seeded with
seed + 1 (log line {"eval_loss", "eval_psnr_batch"}); every
steps_per_eval_image steps one eval camera, in turn, rendered whole:
fine PSNR and SSIM, the coarse PSNR (not with the proposal), the panels
in eval_images/ (log line {"eval_image_<k>"}).  A log line of the loop
counts rays_per_sec from the start of train() and carries the reflect
bucket after that step's controller decision; mask_fraction and
reflect_overflow only with debug_telemetry.  A mesh of several devices is
a later step of the port (ROADMAP.md).  steps_per_dispatch is read as 1:
one step per loop iteration (a CUDA graph of several steps is later work).
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
from rsn_torch.data.blender import load_dataset
from rsn_torch.engine import checkpoints as ckpt_lib
from rsn_torch.engine.optimizers import build_field_optimizer, build_optimizer
from rsn_torch.metrics import psnr, ssim
from rsn_torch.models import camera_opt
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
CAMERA_REG_KEY = "camera_opt_regularizer"


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
            "multi-device render: ROADMAP Queue 1: rsn/parallel/mesh.py "
            "is not ported")
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


@torch.no_grad()
def eval_batch_metrics(field: Field, bundle: RayBundle, gt: torch.Tensor,
                       config: TrainerConfig, step: int,
                       proposal: Optional[ProposalField] = None
                       ) -> Dict[str, float]:
    """rsn's eval-batch step (make_eval_batch_step) on a drawn pixel batch:
    the eval-mode outputs, the loss dict with `step`'s coefficients ->
    {"eval_loss": its sum, "eval_psnr_batch": the PSNR of mid_rgb_fine}."""
    mcfg = config.pipeline.model
    bundle = model_lib.apply_collider(bundle, mcfg)
    outputs = model_lib.get_outputs(field, bundle, mcfg, training=False,
                                    proposal=proposal)
    loss_dict = model_lib.get_loss_dict(outputs, gt,
                                        loss_coefficients(mcfg, step))
    mse = torch.mean((outputs["mid_rgb_fine"] - gt[..., :3]) ** 2)
    return {"eval_loss": float(sum(loss_dict.values())),
            "eval_psnr_batch": float(-10.0 * torch.log10(
                torch.clamp_min(mse, 1e-12)))}


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


def camera_objective(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """What the pose deltas train on: the photometric losses and the pose
    regularizer (rsn's trainer).  The normal and orientation losses'
    sum(w * residual) form would steer rays off the density.  Raises on a
    loss key in neither route's set: the routing would be silently
    wrong."""
    unclassified = (set(loss_dict) - model_lib.PHOTOMETRIC_LOSS_KEYS
                    - model_lib.NON_PHOTOMETRIC_LOSS_KEYS - {CAMERA_REG_KEY})
    if unclassified:
        raise ValueError(
            f"loss keys {sorted(unclassified)} are in neither "
            "model.PHOTOMETRIC_LOSS_KEYS nor NON_PHOTOMETRIC_LOSS_KEYS")
    return sum(v for k, v in loss_dict.items()
               if k in model_lib.PHOTOMETRIC_LOSS_KEYS or k == CAMERA_REG_KEY)


def routed_backward(loss_dict: Dict[str, torch.Tensor], params,
                    camera: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward of the summed losses into `params`' .grad; with the pose
    deltas `camera`, first camera_objective's gradient into camera.grad.
    Two backward passes over one graph, as rsn takes two VJPs: neither
    writes the other's .grad.  -> the total loss."""
    total = sum(loss_dict.values())
    if camera is None:
        total.backward()
        return total
    (cam_grad,) = torch.autograd.grad(camera_objective(loss_dict), [camera],
                                      retain_graph=True)
    total.backward(inputs=list(params))
    camera.grad = cam_grad
    return total


def _check_slice(config: TrainerConfig) -> None:
    """Raise on what the training slice of the port leaves out."""
    if config.num_devices > 1:
        raise NotImplementedError(
            f"num_devices={config.num_devices}: ROADMAP Queue 1: "
            "rsn/parallel/mesh.py (data-parallel mesh) is not ported")
    if config.profile_dir:
        raise NotImplementedError(
            "profile_dir: ROADMAP Queue 1: rsn/engine/trainer.py (the "
            "trainer's profiler window) is not ported")


class Trainer:
    """Run dir, config.json and train_log.jsonl; one training step per
    loop iteration; the adaptive reflect-fraction controller; the eval
    hooks; checkpoints every steps_per_save steps and at the end;
    restore."""

    def __init__(self, config: TrainerConfig, run_dir: Optional[str] = None,
                 device="cuda"):
        _check_slice(config)
        self.config = config
        self.device = torch.device(device)
        dm = config.pipeline.datamanager
        self.train_ds = load_dataset(dm.dataparser, dm.data or "", "train",
                                     dm.downscale_factor, dm.scale_factor)
        try:
            eval_split = "val" if dm.dataparser == "blender" else "test"
            self.eval_ds = load_dataset(dm.dataparser, dm.data or "",
                                        eval_split, dm.downscale_factor,
                                        dm.scale_factor)
        except FileNotFoundError:
            self.eval_ds = self.train_ds
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
        self.camera = camera_opt.init_camera_opt_params(
            self.train_ds.cameras.num_cameras, dm.camera_optimizer,
            self.device)
        self.cam_optimizer = self.cam_scheduler = None
        if self.camera is not None:
            self.cam_optimizer, self.cam_scheduler = build_optimizer(
                [self.camera], config.optimizers["camera_opt"])
        self.images = torch.as_tensor(self.train_ds.images).to(self.device)
        self.cameras = self.train_ds.cameras.to(self.device)
        self.eval_images = torch.as_tensor(self.eval_ds.images).to(self.device)
        self.eval_cameras = self.eval_ds.cameras.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(
            config.seed)
        self.eval_generator = torch.Generator(self.device).manual_seed(
            config.seed + 1)
        self._eval_image_cursor = 0
        self._eval_reflect_memo: Dict = {}
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
        dm = cfg.pipeline.datamanager
        cam = self.camera
        bundle = camera_opt.apply_to_bundle(bundle, cam, dm.camera_optimizer)
        # rays are autograd leaves unless the camera optimizer refines the
        # poses: then the primary passes' backward computes dmc
        outputs = model_lib.get_outputs(
            self.field, bundle, mcfg, training=True,
            generator=self.generator, rays_live=cam is not None,
            proposal=self.proposal,
            prop_anneal=proposal_anneal(mcfg, self.step))
        # the warmup (rsn's loss_coefficients_traced): the normal and
        # orientation losses are zero before WARMUP_STEPS
        loss_dict = model_lib.get_loss_dict(
            outputs, gt, loss_coefficients(mcfg, self.step))
        if cam is not None:
            loss_dict[CAMERA_REG_KEY] = camera_opt.regularization_loss(
                cam, dm.camera_opt_rot_penalty, dm.camera_opt_trans_penalty)
        groups = [(self.optimizer, self.scheduler)]
        params = list(self.field.parameters())
        if self.proposal is not None:
            groups.append((self.prop_optimizer, self.prop_scheduler))
            params += list(self.proposal.parameters())
        if cam is not None:
            groups.append((self.cam_optimizer, self.cam_scheduler))
        for opt, _ in groups:
            opt.zero_grad(set_to_none=True)
        total = routed_backward(loss_dict, params, cam)
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
                             "generator": self.generator.get_state(),
                             "eval_generator":
                                 self.eval_generator.get_state()},
            proposal=self.proposal, proposal_optimizer=self.prop_optimizer,
            proposal_scheduler=self.prop_scheduler, camera=self.camera,
            camera_optimizer=self.cam_optimizer,
            camera_scheduler=self.cam_scheduler)

    def restore(self, load_dir: str) -> None:
        """Resume from the latest checkpoint under load_dir (a run's
        checkpoints directory): field, optimizer, schedule, step, the
        controller state, the proposal field and the camera deltas, each
        with its optimizer and schedule."""
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
        if self.camera is not None:
            with torch.no_grad():
                self.camera.copy_(state["camera"])
            if "camera_optimizer" in state:
                self.cam_optimizer.load_state_dict(state["camera_optimizer"])
            if "camera_scheduler" in state:
                self.cam_scheduler.load_state_dict(state["camera_scheduler"])
        trainer = state.get("trainer", {})
        floor = self.config.pipeline.model.reflect_ray_fraction
        self._reflect_frac = max(float(trainer.get("reflect_fraction",
                                                   floor)), floor)
        self._reflect_down_votes = int(trainer.get("reflect_down_votes", 0))
        if "generator" in trainer:
            self.generator.set_state(trainer["generator"])
        if "eval_generator" in trainer:
            self.eval_generator.set_state(trainer["eval_generator"])

    # ---- the eval hooks (rsn's steps_per_eval_batch / _image) ----

    def eval_batch(self) -> Dict[str, float]:
        """The eval-batch hook: eval_num_rays_per_batch pixels of the eval
        split -> {"eval_loss", "eval_psnr_batch"} (eval_batch_metrics)."""
        bundle, gt = sample_pixel_batch(
            self.eval_images, self.eval_cameras,
            self.config.pipeline.datamanager.eval_num_rays_per_batch,
            self.eval_generator)
        return eval_batch_metrics(self.field, bundle, gt, self.config,
                                  self.step, self.proposal)

    def _eval_image(self, step: int) -> Dict[str, float]:
        """The eval-image hook: the next eval camera in turn, rendered
        whole -> {fine_psnr, fine_ssim[, coarse_psnr], psnr}; its panels go
        to eval_images/{step:09d}-{name}.png."""
        from rsn_torch.cli.render import render_panels, save_png

        idx = self._eval_image_cursor % self.eval_ds.cameras.num_cameras
        self._eval_image_cursor += 1
        out = render_image(self.field, self.eval_cameras, idx, self.config,
                           rays_per_chunk=preferred_eval_chunk(self.config,
                                                               self.device),
                           reflect_memo=self._eval_reflect_memo,
                           proposal=self.proposal)
        gt = self.eval_ds.images[idx]
        mcfg = self.config.pipeline.model
        fine = torch.as_tensor(np.clip(model_lib.final_rgb(out), 0, 1),
                               device=self.device)
        gt_t = torch.as_tensor(gt, device=self.device)
        m = {"fine_psnr": float(psnr(fine, gt_t)),
             "fine_ssim": float(ssim(fine, gt_t))}
        if not mcfg.use_proposal:  # no coarse rgb head with the proposal
            coarse = torch.as_tensor(np.clip(out["mid_rgb_coarse"], 0, 1),
                                     device=self.device)
            m["coarse_psnr"] = float(psnr(coarse, gt_t))
        m["psnr"] = m["fine_psnr"]
        img_dir = os.path.join(self.run_dir, "eval_images")
        os.makedirs(img_dir, exist_ok=True)
        panels = render_panels(out, gt, mcfg.collider_near_plane,
                               mcfg.collider_far_plane)
        for name, img in panels.items():
            save_png(os.path.join(img_dir, f"{step:09d}-{name}.png"), img)
        return m

    # ---- the loop ----

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        self._log_file.write(json.dumps({"step": step, **metrics}) + "\n")
        self._log_file.flush()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Train to max_steps (default max_num_iterations), with rsn's log
        lines: at each log step {"rays_per_sec" (from the start of this
        call), losses, total_loss, reflect_fraction (after the step's
        controller decision)[, mask_fraction, reflect_overflow with
        debug_telemetry]}, then the eval hooks' lines at their cadences.
        -> the last logged line's metrics."""
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
                # sorted, as rsn's device_get of the metrics pytree
                values = {k: float(metrics[k]) for k in sorted(metrics)}
                if cfg.debug_nans and not math.isfinite(values["total_loss"]):
                    raise FloatingPointError(
                        f"step {self.step}: non-finite loss {values}")
            if adapt_now:  # fixed cadence, never the first log
                self._maybe_adapt_reflect_fraction(values)
            if log_now:
                first = False
                self._sync()
                rays_s = ((self.step - step0) * num_rays
                          / (time.perf_counter() - t0))
                logged = dict(values, reflect_fraction=self._reflect_frac)
                if not cfg.debug_telemetry:
                    logged.pop("mask_fraction")
                    logged.pop("reflect_overflow")
                self._log(self.step, {"rays_per_sec": rays_s, **logged})
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
                last = logged
            if hit(cfg.steps_per_eval_batch):
                self._log(self.step, self.eval_batch())
            if hit(cfg.steps_per_eval_image):
                m = self._eval_image(self.step)
                self._log(self.step,
                          {f"eval_image_{k}": v for k, v in m.items()})
                print(f"step {self.step}: eval image psnr={m['psnr']:.2f}",
                      flush=True)
            if hit(cfg.steps_per_save) or self.step == max_steps:
                self.save()
        return last
