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
reflect_overflow only with debug_telemetry.

rsn's chunked dispatch: the loop runs chunks of steps, each cut at the
next log, eval, save, adapt and profile boundary and capped at
steps_per_dispatch (at 1 under debug_nans; _next_chunk), and reads the
device only at a chunk's end, where the chunk ends on a log or adapt
boundary or is the first.  So the log lines, and the controller's
decisions, fall on rsn's steps on every device.  A step reads no Python
value that depends on the step: a step counter on the device, which the
step advances, gives the warmup's loss coefficients, the proposal's
anneal exponent and, on a card, each optimizer's lr (float32, as rsn
traces them; the optimizers capturable).  On a card, one rank or NCCL
ranks, a chunk of n steps is n replays of a CUDA graph of one whole step
(forward, backward, the gradients' all-reduce, the optimizers, the
counter): one graph per reflect bucket (the compaction's K fixes the
shapes, as rsn caches one program per bucket), captured when the bucket
is first needed, after one eager step on a side stream, all in one
memory pool, the train draws' generator registered with each.  A capture
or replay that fails raises, naming the step and the bucket.  On the
CPU, and on gloo ranks (their tensors staged through the host), a chunk
is n eager steps.

With a mesh (rsn_torch.parallel.mesh: one rank per device, a process
each), rsn's data-parallel step: every rank holds a replica (rank 0's,
broadcast after init and after restore), draws its own
train_num_rays_per_batch rays from its own generator (rank_seed), and one
all-reduce averages every live group's gradients (field, proposal, pose
deltas) before the optimizers step, as rsn's pmean does; the metrics are
averaged where the host reads them (log, adapt, debug_nans), so every
rank's controller takes the same decision.  Rank 0 owns the run dir (its
timestamp broadcast), config.json, train_log.jsonl, the tensorboard
writer and the checkpoints, which hold every rank's generator state; each
rank writes its own profiler trace.  The eval image renders sharded over
the ranks (render_image's mesh).

With profile_dir, rsn's profiler window: a torch.profiler trace (the CPU,
and CUDA on a card) from the loop's arrival at profile_start_step for
profile_num_steps steps, written as one Chrome trace JSON into
profile_dir after a device sync; a window that train() ends early is
written when it returns (rsn loses it).  With vis="tensorboard", rsn's
tensorboardX writer in <run_dir>/tb gets every log line's scalars, and a
missing tensorboardX opens nothing and raises nothing.
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

from rsn_torch.configs import (WARMUP_STEPS, WARMUP_ZEROED, TrainerConfig,
                               loss_coefficients_at_step)
from rsn_torch.core.rays import RayBundle
from rsn_torch.data.cameras import Cameras, generate_image_rays, generate_rays
from rsn_torch.data.blender import load_dataset
from rsn_torch.engine import checkpoints as ckpt_lib
from rsn_torch.engine import optimizers as optim_lib
from rsn_torch.kernels import field_forward as ff
from rsn_torch.metrics import psnr, ssim
from rsn_torch.models import camera_opt
from rsn_torch.models import model as model_lib
from rsn_torch.models.field import Field
from rsn_torch.models.proposal import ProposalField
from rsn_torch.parallel import mesh as mesh_lib

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
# the profiler's annotation of each replay of a captured step (a replay
# carries no Optimizer.step annotation of its own)
REPLAY_SPAN = "Trainer.train_step#graph_replay"


@dataclasses.dataclass
class CapturedStep:
    """One reflect bucket's captured train step: the CUDA graph, its
    static metrics (the last replay's), the kernel launches of one step
    (field_forward.LAUNCHES keys), the capture's seconds (host clock) and
    the replays so far."""
    graph: "torch.cuda.CUDAGraph"
    metrics: Dict[str, torch.Tensor]
    launches: Dict[str, int]
    seconds: float
    replays: int = 0


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s train draws.  Rank 0 draws with the run's
    seed, the single device's stream; rank r > 0 with (seed + r *
    0x9E3779B9) mod 2**32, the 32-bit golden-ratio step: distinct for
    every rank in the low 32 bits, all of a seed that the CPU's generator
    keeps, and far from the run's other seeds (seed + 1, the eval draws;
    seed + 2, the proposal's init)."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B9) % 2**32


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
    also carries "mask", the rays that took the reflected passes.

    mesh: every rank of the mesh calls this, and each renders its share
    in rsn's layout: a global chunk of rays_per_chunk * world rays, rank
    r's share its r-th sub-slice, so rank r renders the single device's
    chunks r, r + world, ...; the re-render and the next bucket follow
    the max over the ranks of the overflow and of the worst chunk's mask
    fraction, and every rank returns the whole image (rsn's
    process_allgather), equal to the single device's bit for bit."""
    mcfg = config.pipeline.model
    chunk = rays_per_chunk or mcfg.eval_num_rays_per_chunk
    H, W = cameras.height, cameras.width
    origins, dirs, pixel_area = generate_image_rays(cameras, camera_index)
    total = H * W
    starts = range(0, total, chunk)
    if mesh is not None:
        starts = starts[mesh.rank::mesh.world]

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
        return parts, masks, overflows

    adaptive = (mcfg.adaptive_eval_reflect_fraction and mcfg.use_reflection
                and mcfg.eval_reflect_ray_fraction >= 1.0)
    memo = {} if reflect_memo is None else reflect_memo
    memo_key = (mcfg, chunk)
    frac = memo.get(memo_key, 1.0) if adaptive else 1.0
    while True:
        mcfg_b = (mcfg if frac >= 1.0 else dataclasses.replace(
            mcfg, eval_reflect_ray_fraction=frac))
        parts, masks, overflows = render_all(mcfg_b)
        if not adaptive:
            break
        # (any overflow, the worst chunk's mask fraction, any mask), over
        # every rank of a mesh
        zero = torch.zeros((), device=origins.device)
        stats = torch.stack([
            torch.stack(overflows).amax().float() if overflows else zero,
            torch.stack([m.float().mean() for m in masks]).amax()
            if masks else zero, zero + bool(masks)])
        if mesh is not None:
            stats = mesh_lib.all_reduce_max(mesh, stats)
        overflow, worst, any_mask = stats.tolist()
        if not any_mask:
            break
        need = min(1.0, worst + REFLECT_HEADROOM)
        if frac < 1.0 and overflow > 0:
            # straight to the bucket the observed mask needs (one re-render)
            frac = next(b for b in REFLECT_FRACTION_BUCKETS
                        if b > frac and b >= need)
            continue
        memo[memo_key] = next(b for b in REFLECT_FRACTION_BUCKETS
                              if b >= need)
        break

    if mesh is not None:
        return _gather_image(mesh, parts, masks, total, chunk, H, W)
    result = {k: torch.cat(v).reshape(H, W, -1).float().cpu().numpy()
              for k, v in parts.items()}
    if masks:
        result["mask"] = torch.cat(masks).reshape(H, W, 1).cpu().numpy()
    return result


def _gather_image(mesh, parts: Dict[str, list], masks: list, total: int,
                  chunk: int, H: int, W: int) -> Dict[str, np.ndarray]:
    """Every rank's chunks (render_image's layout) -> the whole image on
    every rank: one all_gather_rows of each rank's rows, every output (and
    the mask) as float32 columns, put back in the single device's chunk
    order.  Rank 0, which always holds chunk 0, names the columns."""
    if mesh.is_primary:
        schema = [(k, v[0].reshape(v[0].shape[0], -1).shape[1])
                  for k, v in parts.items()]
        if masks:
            schema.append(("mask", 1))
    schema = mesh_lib.broadcast_object(
        mesh, schema if mesh.is_primary else None)
    cols = parts | ({"mask": masks} if masks else {})
    mine = [torch.cat(cols[k]).reshape(-1, c).float() for k, c in schema
            if cols.get(k)]
    width = sum(c for _, c in schema)
    local = (torch.cat(mine, dim=1) if mine
             else torch.zeros((0, width), device=mesh.device))
    ranks = mesh_lib.all_gather_rows(mesh, local)
    # rank r's rows are its chunks r, r + world, ... in order
    sizes = [min(chunk, total - s) for s in range(0, total, chunk)]
    pieces = [list(torch.split(rows, sizes[r::mesh.world]))
              for r, rows in enumerate(ranks)]
    image = torch.cat([pieces[i % mesh.world][i // mesh.world]
                       for i in range(len(sizes))]).cpu()
    result, off = {}, 0
    for k, c in schema:
        block = image[:, off:off + c].reshape(H, W, c)
        result[k] = (block > 0).numpy() if k == "mask" else block.numpy()
        off += c
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


def loss_coefficients_traced(mcfg, step: torch.Tensor
                             ) -> Dict[str, object]:
    """loss_coefficients at the step counter `step` (a tensor), as rsn's
    loss_coefficients_traced: each warmup term v * f32(step >=
    WARMUP_STEPS) on the counter's device, the others their constant."""
    on = (step >= WARMUP_STEPS).to(torch.float32)
    return {k: v * on if k in WARMUP_ZEROED else v
            for k, v in loss_coefficients(mcfg, WARMUP_STEPS).items()}


def proposal_anneal_traced(mcfg, step: torch.Tensor
                           ) -> Optional[torch.Tensor]:
    """proposal_anneal at the step counter `step` (a tensor), float32 on
    its device as rsn traces it; None when off.  The divisor is a tensor:
    CUDA divides by a host scalar through its reciprocal."""
    n = mcfg.proposal_weights_anneal_max_num_iters
    if not (mcfg.use_proposal and n):
        return None
    frac = torch.clamp(step.to(torch.float32) / torch.full(
        (), n, dtype=torch.float32, device=step.device), 0.0, 1.0)
    s = mcfg.proposal_weights_anneal_slope
    return (s * frac) / ((s - 1.0) * frac + 1.0)


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


class Trainer:
    """Run dir, config.json and train_log.jsonl; one training step per
    loop iteration; the adaptive reflect-fraction controller; the eval
    hooks; checkpoints every steps_per_save steps and at the end;
    restore.  mesh: this rank's mesh (rsn_torch.parallel.mesh), for a
    group of any size; the trainer then runs on the mesh's device."""

    def __init__(self, config: TrainerConfig, run_dir: Optional[str] = None,
                 device="cuda", mesh: Optional[mesh_lib.Mesh] = None):
        if mesh is None and config.num_devices > 1:
            raise ValueError(
                f"num_devices={config.num_devices} outside a process group: "
                "each rank builds its Trainer with its mesh, in processes "
                "that rsn_torch.parallel.mesh.launch (or torchrun) starts; "
                "the train CLI does it for --num-devices N and --multihost")
        self.config = config
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.num_devices = mesh.world if mesh is not None else 1
        self.is_primary = self.rank == 0
        self.device = mesh.device if mesh is not None else torch.device(
            device)
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
            t = time.time()
            if mesh is not None:  # rank 0's clock names the run dir
                t = mesh_lib.broadcast_object(mesh, t)
            ts = time.strftime("%Y-%m-%d_%H%M%S", time.localtime(t))
            run_dir = os.path.join(config.output_dir, config.experiment_name,
                                   config.method_name, ts)
        self.run_dir = run_dir
        self.ckpt_dir = os.path.join(run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        if self.is_primary:
            ckpt_lib.dump_config(run_dir, config)

        # the step counter the step reads and advances; on a card the
        # optimizers' lr follows it (their capturable form)
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        counter = self._step_t if self.device.type == "cuda" else None
        self.field = Field(torch.Generator().manual_seed(config.seed)).to(
            self.device)
        self.optimizer, self.scheduler = optim_lib.build_field_optimizer(
            self.field, config.optimizers, counter)
        self.proposal = self.prop_optimizer = self.prop_scheduler = None
        if config.pipeline.model.use_proposal:
            self.proposal = ProposalField(
                torch.Generator().manual_seed(config.seed + 2)).to(self.device)
            self.prop_optimizer, self.prop_scheduler = (
                optim_lib.build_optimizer(
                    self.proposal.parameters(),
                    config.optimizers["proposal_networks"], counter))
        self.camera = camera_opt.init_camera_opt_params(
            self.train_ds.cameras.num_cameras, dm.camera_optimizer,
            self.device)
        self.cam_optimizer = self.cam_scheduler = None
        if self.camera is not None:
            self.cam_optimizer, self.cam_scheduler = optim_lib.build_optimizer(
                [self.camera], config.optimizers["camera_opt"], counter)
        self.images = torch.as_tensor(self.train_ds.images).to(self.device)
        self.cameras = self.train_ds.cameras.to(self.device)
        self.eval_images = torch.as_tensor(self.eval_ds.images).to(self.device)
        self.eval_cameras = self.eval_ds.cameras.to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(
            rank_seed(config.seed, self.rank))
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
        # the captured steps, by reflect bucket (a card with one rank or
        # NCCL ranks), and their shared memory pool
        self._graphed = self.device.type == "cuda" and (
            mesh is None or mesh.backend == "nccl")
        self.graphs: Dict[float, CapturedStep] = {}
        self._pool = None
        if mesh is not None:
            self._broadcast_replicas()
        self._log_file = (open(os.path.join(run_dir, "train_log.jsonl"), "a")
                          if self.is_primary else None)
        self._tb = None
        if config.vis == "tensorboard" and self.is_primary:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception:
                pass

    def _broadcast_replicas(self) -> None:
        """Rank 0's field, proposal field and pose deltas on every rank."""
        mesh_lib.broadcast_module(self.mesh, self.field)
        if self.proposal is not None:
            mesh_lib.broadcast_module(self.mesh, self.proposal)
        if self.camera is not None:
            mesh_lib.broadcast_(self.mesh, [self.camera])

    # ---- one step ----

    def live_params(self) -> list:
        """The trained tensors of every live group: the field's, the
        proposal field's, the pose deltas."""
        params = list(self.field.parameters())
        if self.proposal is not None:
            params += list(self.proposal.parameters())
        if self.camera is not None:
            params.append(self.camera)
        return params

    @property
    def step(self) -> int:
        """The steps taken.  Setting it sets the device's step counter
        too, which the step's schedules read."""
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self._step_t.fill_(self._step)

    def train_step(self) -> Dict[str, torch.Tensor]:
        """One optimizer step, eager -> this step's losses and telemetry,
        as device scalars (no host sync).  With a mesh, one all-reduce
        averages every live group's gradients over the ranks first."""
        metrics = self._step_once()
        self._step += 1
        return metrics

    def _step_once(self) -> Dict[str, torch.Tensor]:
        """The step a graph captures: train_step without the host's step
        count (the device's counter advances)."""
        metrics, groups = self.forward_backward()
        if self.mesh is not None:
            mesh_lib.average_gradients(self.mesh, self.live_params())
        for opt, sched in groups:
            if isinstance(sched, optim_lib.CounterDecay):
                sched.apply()
            opt.step()
            sched.step()
        self._step_t += 1
        return metrics

    def forward_backward(self):
        """This rank's batch from its generator: forward, losses, and the
        backward into every live group's .grad -> (the step's losses and
        telemetry, the live groups' (optimizer, schedule))."""
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
            prop_anneal=proposal_anneal_traced(mcfg, self._step_t))
        # the warmup (rsn's loss_coefficients_traced): the normal and
        # orientation losses are zero before WARMUP_STEPS
        loss_dict = model_lib.get_loss_dict(
            outputs, gt, loss_coefficients_traced(mcfg, self._step_t))
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
        return dict({k: v.detach() for k, v in loss_dict.items()},
                    total_loss=total.detach(),
                    mask_fraction=outputs["mask"].float().mean(),
                    reflect_overflow=outputs["reflect_overflow"]), groups

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
        if self.is_primary:
            print(f"reflect compaction: fraction -> {frac:g}", flush=True)
        self._reflect_frac = frac

    # ---- checkpoints ----

    def save(self) -> str:
        """Write this step's checkpoint (rank 0; "generator" is its draws'
        state, and with several ranks "rank_generators" holds every
        rank's, gathered) -> its path.  Every rank of a mesh takes part
        and leaves after the write."""
        trainer = {"reflect_fraction": self._reflect_frac,
                   "reflect_down_votes": self._reflect_down_votes,
                   "generator": self.generator.get_state(),
                   "eval_generator": self.eval_generator.get_state()}
        if self.num_devices > 1:
            trainer["rank_generators"] = mesh_lib.all_gather_object(
                self.mesh, self.generator.get_state())
        path = os.path.join(self.ckpt_dir, f"step-{self.step:09d}.pt")
        if self.is_primary:
            path = ckpt_lib.save_checkpoint(
                self.ckpt_dir, self.step, self.field, self.optimizer,
                self.scheduler, trainer, proposal=self.proposal,
                proposal_optimizer=self.prop_optimizer,
                proposal_scheduler=self.prop_scheduler, camera=self.camera,
                camera_optimizer=self.cam_optimizer,
                camera_scheduler=self.cam_scheduler)
        if self.mesh is not None:
            mesh_lib.barrier(self.mesh)
        return path

    def _read_checkpoint(self, load_dir: str):
        """The latest checkpoint under load_dir, read by rank 0 and
        broadcast: every rank restores rank 0's bytes."""
        state = None
        if self.is_primary:
            path = ckpt_lib.latest_checkpoint(load_dir)
            state = (ckpt_lib.load_checkpoint(path) if path is not None
                     else FileNotFoundError(f"no checkpoints under "
                                            f"{load_dir}"))
        if self.mesh is not None:
            state = mesh_lib.broadcast_object(self.mesh, state)
        if isinstance(state, Exception):
            raise state
        return state

    def restore(self, load_dir: str) -> None:
        """Resume from the latest checkpoint under load_dir (a run's
        checkpoints directory): field, optimizer, schedule, step, the
        controller state, the proposal field and the camera deltas, each
        with its optimizer and schedule, and the draws: with several
        ranks, each rank's own state (a rank the checkpoint has no state
        for keeps its seed's).  The modules and the pose deltas are
        written in place; the optimizers' state is not, so the captured
        steps are dropped and captured again."""
        state = self._read_checkpoint(load_dir)
        self.graphs.clear()
        self._pool = None
        self.field.load_state_dict(state["field"])
        self.step = int(state["step"])
        optim_lib.load_state(self.optimizer, self.scheduler,
                             state.get("optimizer"), state.get("scheduler"))
        if self.proposal is not None:
            self.proposal.load_state_dict(state["proposal"])
            optim_lib.load_state(self.prop_optimizer, self.prop_scheduler,
                                 state.get("proposal_optimizer"),
                                 state.get("proposal_scheduler"))
        if self.camera is not None:
            with torch.no_grad():
                self.camera.copy_(state["camera"])
            optim_lib.load_state(self.cam_optimizer, self.cam_scheduler,
                                 state.get("camera_optimizer"),
                                 state.get("camera_scheduler"))
        trainer = state.get("trainer", {})
        floor = self.config.pipeline.model.reflect_ray_fraction
        self._reflect_frac = max(float(trainer.get("reflect_fraction",
                                                   floor)), floor)
        self._reflect_down_votes = int(trainer.get("reflect_down_votes", 0))
        gens = trainer.get("rank_generators") or [trainer.get("generator")]
        if self.rank < len(gens) and gens[self.rank] is not None:
            self.generator.set_state(gens[self.rank])
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
                           mesh=self.mesh,
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
        if not self.is_primary:
            return m
        img_dir = os.path.join(self.run_dir, "eval_images")
        os.makedirs(img_dir, exist_ok=True)
        panels = render_panels(out, gt, mcfg.collider_near_plane,
                               mcfg.collider_far_plane)
        for name, img in panels.items():
            save_png(os.path.join(img_dir, f"{step:09d}-{name}.png"), img)
        return m

    # ---- the loop ----

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._log_file is None:  # a rank other than 0
            return
        self._log_file.write(json.dumps({"step": step, **metrics}) + "\n")
        self._log_file.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def _host_metrics(self, metrics: Dict[str, torch.Tensor]
                      ) -> Dict[str, float]:
        """The step's metrics on the host, sorted as rsn's device_get of
        the metrics pytree; with a mesh, their mean over the ranks (one
        all-reduce), so every rank reads the same values."""
        keys = sorted(metrics)
        if self.mesh is None:
            return {k: float(metrics[k]) for k in keys}
        (mean,) = mesh_lib.all_reduce_mean(
            self.mesh, [torch.stack([metrics[k].float() for k in keys])])
        return dict(zip(keys, mean.tolist()))

    def _print_line(self, values: Dict[str, float], rays_s: float) -> None:
        if not self.is_primary:
            return
        losses = " ".join(f"{k}={values[k]:.6g}" for k in sorted(values)
                          if k.startswith(("loss", "predicted", "orientation",
                                           "interlevel", "distortion")))
        print(f"step {self.step}: loss={values['total_loss']:.6g} {losses} "
              f"mask fraction {values['mask_fraction']:.4f}, reflect bucket "
              f"{self._reflect_frac:g}, {rays_s:.1f} rays/s", flush=True)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_trace(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
            # Kineto keeps CUPTI attached after the trace unless asked to
            # tear it down, and attached it slows every later launch: the
            # steps after the window and the rest of the process ran
            # 15-25% slower on an H100 (chip_smoke.py phase 21).  Set
            # before the trace starts, where torch.profiler sets it itself
            # for CUDA graphs; a value the caller set stands.
            os.environ.setdefault("TEARDOWN_CUPTI", "1")
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof: torch.profiler.profile, start: int) -> None:
        """Sync, stop, and write the trace (the trainer's step count at the
        window's start and end in its name)."""
        self._sync()
        prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        rank = f"_rank{self.rank}" if self.num_devices > 1 else ""
        path = os.path.join(self.config.profile_dir,
                            f"trace_step{start:06d}_to_step{self.step:06d}"
                            f"{rank}.json")
        prof.export_chrome_trace(path)

    # ---- the dispatch (rsn's _next_chunk and multi-step program) ----

    def _next_chunk(self, step: int, max_steps: int) -> int:
        """Steps to run in the next chunk: the distance to the nearest
        log, eval, save, adapt or profile boundary (or max_steps), capped
        by steps_per_dispatch (by 1 under debug_nans)."""
        cfg = self.config
        cap = 1 if cfg.debug_nans else max(1, cfg.steps_per_dispatch)
        cadences = [cfg.steps_per_log, cfg.steps_per_eval_batch,
                    cfg.steps_per_eval_image, cfg.steps_per_save]
        if cfg.adaptive_reflect_fraction:
            cadences.append(self._adapt_cadence)
        nxt = max_steps
        for c in cadences:
            if c > 0:
                nxt = min(nxt, (step // c + 1) * c)
        if cfg.profile_dir:
            for boundary in (cfg.profile_start_step,
                             cfg.profile_start_step + cfg.profile_num_steps):
                if boundary > step:
                    nxt = min(nxt, boundary)
        return min(cap, nxt - step)

    def _run_chunk(self, n: int) -> Dict[str, torch.Tensor]:
        """n steps -> the last step's metrics (device scalars, no host
        sync).  Graphed: n replays of the bucket's captured step (its
        first use takes one eager step and the capture first), each
        annotated REPLAY_SPAN for the profiler, each adding the step's
        kernel launches to field_forward.LAUNCHES.  Otherwise n eager
        train_step calls."""
        if not self._graphed:
            for _ in range(n):
                metrics = self.train_step()
            return metrics
        frac = self._reflect_frac
        captured = self.graphs.get(frac)
        if captured is None:
            metrics = self._warm_up()
            n -= 1
            captured = self.graphs[frac] = self._capture(frac)
        for i in range(n):
            try:
                with torch.profiler.record_function(REPLAY_SPAN):
                    captured.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(
                    f"replaying the train step of reflect bucket {frac:g} "
                    f"failed at step {self._step + i + 1}: {e}") from e
        if n:
            self._step += n
            captured.replays += n
            for k, v in captured.launches.items():
                ff.LAUNCHES[k] += n * v
            metrics = captured.metrics
        return metrics

    def _warm_up(self) -> Dict[str, torch.Tensor]:
        """One eager train step on a side stream, before a capture: the
        kernels' first launches (builds, cached constants), the optimizer
        state, the mesh's first all-reduce check."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            metrics = self.train_step()
        main.wait_stream(side)
        return metrics

    def _capture(self, frac: float) -> "CapturedStep":
        """Capture one step of reflect bucket `frac` into a CUDA graph in
        the trainer's pool, the train draws' generator registered; the
        capture runs nothing, so the launch counts it made are taken back
        and kept as the step's."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = dict(ff.LAUNCHES)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                metrics = self._step_once()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the train step of reflect bucket {frac:g} at "
                f"step {self._step} failed: {e}") from e
        finally:
            launches = {k: v - before[k] for k, v in ff.LAUNCHES.items()
                        if v != before[k]}
            ff.LAUNCHES.update(before)
        if self._pool is None:
            self._pool = graph.pool()
        return CapturedStep(graph, metrics, launches,
                            time.perf_counter() - t0)

    # ---- the loop ----

    def train(self, max_steps: Optional[int] = None) -> Dict[str, float]:
        """Train to max_steps (default max_num_iterations) in rsn's chunks,
        with rsn's log lines: at each log step, and at the end of the
        first chunk, {"rays_per_sec" (from the start of this call, the
        rays of every rank), losses, total_loss, reflect_fraction (after
        the step's controller decision)[, mask_fraction, reflect_overflow
        with debug_telemetry]}, then the eval hooks' lines at their
        cadences; the profiler window from the loop's arrival at
        profile_start_step.  -> the last logged line's metrics."""
        cfg = self.config
        max_steps = max_steps or cfg.max_num_iterations
        num_rays = cfg.pipeline.datamanager.train_num_rays_per_batch
        hit = lambda c: c > 0 and self.step % c == 0
        last: Dict[str, float] = {}
        self._sync()
        t0, step0 = time.perf_counter(), self.step
        first = True
        prof, prof_start = None, cfg.profile_start_step
        while self.step < max_steps:
            if cfg.profile_dir and self.step == prof_start:
                prof = self._start_trace()
            metrics = self._run_chunk(self._next_chunk(self.step, max_steps))
            if prof is not None and self.step >= (
                    prof_start + cfg.profile_num_steps):
                self._stop_trace(prof, prof_start)
                prof = None
            adapt_now = (cfg.adaptive_reflect_fraction
                         and hit(self._adapt_cadence))
            log_now = hit(cfg.steps_per_log) or first
            if cfg.debug_nans or adapt_now or log_now:
                values = self._host_metrics(metrics)
                if cfg.debug_nans and not math.isfinite(values["total_loss"]):
                    raise FloatingPointError(
                        f"step {self.step}: non-finite loss {values}")
            if adapt_now:  # fixed cadence, never the first log
                self._maybe_adapt_reflect_fraction(values)
            if log_now:
                first = False
                self._sync()
                rays_s = ((self.step - step0) * num_rays * self.num_devices
                          / (time.perf_counter() - t0))
                logged = dict(values, reflect_fraction=self._reflect_frac)
                if not cfg.debug_telemetry:
                    logged.pop("mask_fraction")
                    logged.pop("reflect_overflow")
                self._log(self.step, {"rays_per_sec": rays_s, **logged})
                self._print_line(values, rays_s)
                last = logged
            if hit(cfg.steps_per_eval_batch):
                self._log(self.step, self.eval_batch())
            if hit(cfg.steps_per_eval_image):
                m = self._eval_image(self.step)
                self._log(self.step,
                          {f"eval_image_{k}": v for k, v in m.items()})
                if self.is_primary:
                    print(f"step {self.step}: eval image psnr="
                          f"{m['psnr']:.2f}", flush=True)
            if hit(cfg.steps_per_save) or self.step == max_steps:
                self.save()
        if prof is not None:  # the window outlived the loop
            self._stop_trace(prof, prof_start)
        return last
