"""Dataclass config tree mirroring the reference's registration surface
(the port's own copy of rsn.configs: the same classes, fields and
defaults, so a run's config.json reads the same in both packages).

Field names track the reference so CLI overrides translate 1:1:
- TrainerConfig      <- reflect_sampling_nerf_config.py:28-61
- PipelineConfig     <- reflect_sampling_nerf_pipeline.py:26-35
- DataManagerConfig  <- reflect_sampling_nerf_datamanager.py:17-24 +
                        train/eval_num_rays_per_batch (config.py:37-38)
- ModelConfig        <- reflect_sampling_nerf_model.py:38-75 (sample counts,
                        loss coefficients, collider params, eval chunk)
- optimizer table    <- config.py:44-58 (three groups; only "fields" binds
                        parameters — replicated quirk, SURVEY.md B#6)

The 50-step warmup of the normal/orientation loss coefficients
(pipeline.py:79-91) is expressed as the pure function
`loss_coefficients_at_step` instead of config mutation.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dfield
from typing import Dict, Optional

LOSS_COEFFICIENTS: Dict[str, float] = {
    # model.py:56-69; "low" entries retained for key parity but unused
    "loss_low_coarse": 1e-1,
    "loss_low_fine": 1e-1,
    "loss_mid_coarse": 1.0,
    "loss_mid_fine": 1.0,
    "loss_reflect_low_coarse": 1e-1,
    "loss_reflect_low_fine": 1e-1,
    "loss_reflect_mid_coarse": 1.0,
    "loss_reflect_mid_fine": 1.0,
    "predicted_normal_loss_coarse": 3e-5,
    "predicted_normal_loss_fine": 3e-4,
    "orientation_loss_coarse": 1e-2,
    "orientation_loss_fine": 1e-1,
}

WARMUP_ZEROED = (
    "predicted_normal_loss_coarse", "predicted_normal_loss_fine",
    "orientation_loss_coarse", "orientation_loss_fine",
)
WARMUP_STEPS = 50  # pipeline.py:80


def loss_coefficients_at_step(step: int) -> Dict[str, float]:
    """Pure per-step schedule replacing the reference's config mutation."""
    coeffs = dict(LOSS_COEFFICIENTS)
    if step < WARMUP_STEPS:
        for k in WARMUP_ZEROED:
            coeffs[k] = 0.0
    return coeffs


@dataclass(frozen=True)
class BugCompat:
    """Replicate-vs-fix switches for the reference's quirks (SURVEY.md App B)."""
    sh_l8_m7_2x: bool = True          # B#1: l=8 m=+-7 SH coeffs 2x
    reflect_near_zero: bool = True    # B#2: reflected rays start at surface
    # r4 CORRECTION: nerfstudio's RGBRenderer default bg "random"
    # (reference renderer_factor, reflect_sampling_nerf_model.py:123)
    # returns the composite WITHOUT blending at combine time ("as if
    # the background color was black") — random blending exists only
    # in blend_background_for_loss_computation, which the reference
    # routes through the WHITE renderer_rgb.  r1-r3 mis-replicated
    # this as an actual per-ray random blend, injecting (1-acc)-scaled
    # uniform noise into the tint composite at train AND eval —
    # measured −5 dB of pure speckle on the shinyfloor product image.
    # True reference semantics = False (no background term on tint).
    tint_random_background: bool = False
    depth_method: str = "median"      # B#9


@dataclass(frozen=True)
class ModelConfig:
    num_coarse_samples: int = 128
    num_importance_samples: int = 128
    num_reflect_coarse_samples: int = 64
    num_reflect_importance_samples: int = 64
    eval_num_rays_per_chunk: int = 1 << 10
    collider_near_plane: float = 2.0   # base ModelConfig collider_params
    collider_far_plane: float = 6.0
    reflect_near: float = 1.0 / 16     # model.py:114 (dead when nears=0)
    reflect_far: float = 2.0 ** 8      # model.py:113
    reciprocal_tan: float = 0.25       # model.py:111
    mask_accumulation_threshold: float = 1e-2  # model.py:229
    # TRAINING-ONLY fixed-shape compaction: reflected passes run on the
    # top-K masked rays, K = fraction * batch.  Exact reference
    # semantics while #masked <= K (the reference itself only pays for
    # masked rays via boolean gather, model.py:267); overflow beyond the
    # cap falls back to the background fill and is reported by the
    # "reflect_overflow" output.  The trainer ADAPTS this cap upward
    # (never below this configured floor) when the observed mask
    # fraction approaches it — see trainer.REFLECT_FRACTION_BUCKETS;
    # set 1.0 (+ adaptive off) to force all-rays processing.  Eval and
    # render always process every masked ray (fraction ignored).
    reflect_ray_fraction: float = 0.5
    # eval/render-mode cap (1.0 = process every masked ray exactly,
    # like the reference's gather; lower it only for preview renders)
    eval_reflect_ray_fraction: float = 1.0
    # Adaptive eval-side compaction (engine/trainer.render_image): full
    # renders start at the remembered bucket, and any chunk whose
    # masked rays overflow the cap triggers an automatic re-render at a
    # larger bucket — results are bit-identical to fraction 1.0 (only
    # masked rays ever pay the reflected passes, exactly the
    # reference's gather, model.py:267), but unmasked rays stop paying
    # for them.  Only active when eval_reflect_ray_fraction == 1.0 (an
    # explicit lower setting is a user-chosen approximation and wins).
    adaptive_eval_reflect_fraction: bool = True
    # Optional proposal-network sampling (rsn/models/proposal.py): the
    # coarse pass runs a small density-only field trained against the
    # mip-NeRF-360 interlevel loss, binding the reference's otherwise
    # empty "proposal_networks" optimizer group.  A deliberate
    # acceleration deviation; off by default (reference behavior).
    # Primary-only model family (the "mipnerf" method): False skips the
    # reflected passes 3/4 and their outputs/losses entirely —
    # mid_rgb_fine becomes the product image.  No reference counterpart
    # (the reference model is always reflection-aware); True is the
    # reference behavior.
    use_reflection: bool = True
    use_proposal: bool = False
    num_proposal_samples: int = 64
    interlevel_loss_mult: float = 1.0
    # Extends proposal sampling to the REFLECTED coarse pass (pass 3):
    # the small proposal field places pass 4's PDF samples on the
    # reflected rays, dropping pass 3's full-field evaluation (and its
    # rgb loss) the same way use_proposal drops pass 1's; the proposal
    # trains on a second interlevel term over the reflected histograms
    # (reciprocal spacing domain).  Only read when use_proposal.
    use_proposal_reflect: bool = False
    # mip-NeRF-360 proposal-weight annealing: for the first N steps the
    # fine pass resamples from w_prop**anneal with anneal ramping 0 -> 1
    # (bias curve, slope below), so early training sees near-uniform
    # fine samples instead of an untrained proposal's spikes.  Fixes the
    # long-horizon quality gap of interlevel-only supervision
    # (VERDICT r1 #6).  0 disables.
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    # mip-NeRF-360 distortion regularizer on the LIVE fine weights
    # (spacing domain).  Proposal mode drops the reference's coarse-pass
    # rgb/normal losses, losing their free-space regularization; the
    # distortion loss restores it (floater suppression).  Only read in
    # proposal mode; OFF (0.0) in the parity default.
    distortion_loss_mult: float = 0.0
    # Config-only knob, never read — replicates the reference exactly
    # (reflect_sampling_nerf_model.py:71-74 declares DNERF temporal
    # distortion with enable=False and no consumer; SURVEY.md §2.2).
    enable_temporal_distortion: bool = False
    temporal_distortion_kind: str = "dnerf"
    background_color: str = "white"    # model.py:117
    compute_dtype: str = "float32"     # "bfloat16" for the trunk matmuls
    # The fused field kernels.  They run only with compute_dtype
    # "bfloat16"; float32 runs take the plain field.
    #   use_pallas:       the field forward kernels on the render path
    #                     (rsn_torch: K1 field_forward_v3, K2
    #                     field_forward_density)
    #   use_pallas_train: the fused training field (rsn_torch: the
    #                     FusedFieldTrain autograd Function around K3-K5)
    use_pallas_train: bool = True
    use_pallas: bool = True
    #   use_pallas_proposal: the proposal-density kernel on the render
    #                     path (rsn_torch: K9 prop_forward; off by
    #                     default)
    use_pallas_proposal: bool = False
    #   use_pallas_acts:  with use_pallas_train, the forward spills the
    #                     trunk activations and the backward reads them
    #                     (rsn_torch: K3 with K4 / K5); False recomputes
    #                     the trunk in the backward and keeps no spill
    #                     (K7, K1 at the train width, K8)
    use_pallas_acts: bool = True
    #   pallas_interpret: JAX-package test switch (Pallas interpret
    #                     mode); the port never reads it
    pallas_interpret: bool = False
    bug_compat: BugCompat = dfield(default_factory=BugCompat)


@dataclass(frozen=True)
class DataManagerConfig:
    dataparser: str = "blender"  # blender | nerfstudio | instant-ngp | synthetic
    data: Optional[str] = None         # dataset path
    train_num_rays_per_batch: int = 1024
    eval_num_rays_per_batch: int = 1024
    alpha_color: str = "white"         # Blender RGBA -> RGB blending
    scale_factor: float = 1.0
    downscale_factor: int = 1
    # pose refinement: "off" (reference behavior — the camera_opt
    # optimizer group binds nothing, SURVEY.md B#6) or "SO3xR3"
    # (per-camera se(3) deltas trained by the camera_opt group;
    # rsn_torch/models/camera_opt.py)
    camera_optimizer: str = "off"
    # L2 gauge regularizer on the pose deltas (nerfstudio
    # CameraOptimizerConfig rot_l2_penalty / trans_l2_penalty
    # semantics); keeps poses from drifting when they are already good,
    # at the cost of biasing large genuine corrections low
    camera_opt_rot_penalty: float = 1e-3
    camera_opt_trans_penalty: float = 1e-2


@dataclass(frozen=True)
class OptimizerGroupConfig:
    optimizer: str = "adam"            # adam | radam
    lr: float = 1e-3
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 50000


@dataclass(frozen=True)
class PipelineConfig:
    datamanager: DataManagerConfig = dfield(default_factory=DataManagerConfig)
    model: ModelConfig = dfield(default_factory=ModelConfig)


def _default_optimizers() -> Dict[str, OptimizerGroupConfig]:
    return {
        # config.py:44-58; proposal_networks/camera_opt bind no params (B#6)
        "proposal_networks": OptimizerGroupConfig(
            optimizer="adam", lr=1e-3, eps=1e-15,
            lr_final=1e-4, max_steps=200000),
        "fields": OptimizerGroupConfig(
            optimizer="radam", lr=1e-3, eps=1e-15,
            lr_final=1e-4, max_steps=50000),
        "camera_opt": OptimizerGroupConfig(
            optimizer="adam", lr=1e-3, eps=1e-15,
            lr_final=1e-4, max_steps=5000),
    }


@dataclass(frozen=True)
class TrainerConfig:
    method_name: str = "reflect-sampling-nerf"
    experiment_name: str = "unnamed"
    output_dir: str = "outputs"
    steps_per_eval_batch: int = 100
    steps_per_eval_image: int = 500
    steps_per_save: int = 1000
    max_num_iterations: int = 100000
    mixed_precision: bool = True       # bf16 trunk (no GradScaler)
    seed: int = 42
    pipeline: PipelineConfig = dfield(default_factory=PipelineConfig)
    optimizers: Dict[str, OptimizerGroupConfig] = dfield(
        default_factory=_default_optimizers)
    # parallelism: number of devices for the data mesh axis (0 = all)
    num_devices: int = 0
    # adaptive reflect-compaction cap (see ModelConfig.reflect_ray_
    # fraction): the trainer raises the cap when the observed mask
    # fraction approaches it and relaxes it back toward the configured
    # floor when it doesn't.  Off = the configured fraction is static.
    adaptive_reflect_fraction: bool = True
    steps_per_log: int = 10
    # steps fused into one device dispatch, capped by the distance to
    # the next log/eval/save event (the JAX trainer's knob; the port
    # runs one step per loop iteration, a CUDA graph is later work).
    steps_per_dispatch: int = 100
    viewer_num_rays_per_chunk: int = 1 << 10
    # --- observability (SURVEY.md §5.1/§5.2: replaces the reference's
    # unconditional host-sync prints and the near-dead NaN tripwire) ---
    debug_nans: bool = False      # stop at a non-finite loss
    debug_telemetry: bool = False  # per-step mask/loss stats in the log
    profile_dir: str = ""         # profiler trace dir ("" = off)
    profile_start_step: int = 20
    profile_num_steps: int = 5
    vis: str = "jsonl"            # jsonl | tensorboard (both write jsonl)


def replace(cfg, **kwargs):
    return dataclasses.replace(cfg, **kwargs)
