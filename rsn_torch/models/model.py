"""The 4-pass reflect-sampling NeRF renderer and its losses (port of
rsn.models.model).

  pass 1 coarse:          128 uniform samples in [near=2, far=6]
  pass 2 fine:            128 PDF samples from the coarse weights
  pass 3 reflect coarse:  64 reciprocal-spaced samples on the secondary
                          rays spawned at the fine median depth
  pass 4 reflect fine:    64 PDF samples from the pass-3 weights

With compute_dtype "bfloat16" and cfg.use_pallas, every full field
evaluation of a render goes through K1 and every density-only one through
K2 (rsn_torch.kernels.field_forward); a training forward with
cfg.use_pallas_train goes through the FusedFieldTrain autograd Function
(rsn_torch.kernels.field_train): with cfg.use_pallas_acts the spill route
(K3 forward, K4 or K5 backward), else the recompute route (K7 on passes 1
and 2, K1 at the train width on passes 3 and 4, K8 backward).  The
wrappers launch the CUDA kernels for CUDA tensors and run their plain
versions for CPU tensors.  Other configs run the plain field
(rsn_torch.models.field), under autograd when training.

With cfg.use_proposal and a ProposalField passed (the
reflect-sampling-nerf-proposal preset), pass 1 runs the small proposal
field instead of the main field (density only), and with
cfg.use_proposal_reflect so does pass 3; the fine passes resample from its
weights (annealed by prop_anneal).  Its density is the fp32 composition
(rsn_torch.models.proposal), or on the render path with
cfg.use_pallas_proposal and bf16 the K9 kernel
(rsn_torch.kernels.proposal_forward).

The .detach() pattern is rsn's stop_gradient pattern (the reference's):
ray-level diff / tint / pred-normals / n.d, the reflected weights, the
roughness into the directional encoding, the reflected rays' origins and
directions, the PDF bins.

Meshes are a later step of the port (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rsn_torch.configs import ModelConfig
from rsn_torch.core.contract import contract_blob, packed_contract_planes
from rsn_torch.core.rays import RayBundle, RaySamples, get_gaussian_blob
from rsn_torch.core.render import (blend_background_for_loss_computation,
                                   composite_planes, normalize,
                                   render_accumulation, render_depth_median,
                                   render_depth_median_planes, render_normals,
                                   render_rgb, render_rgb_planes,
                                   render_scalar, safe_sqrt, weights_planes,
                                   white)
from rsn_torch.core.sampling import pdf_sample
from rsn_torch.core.spacing import (identity_spacing, reciprocal_spacing,
                                    spaced_sample)
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as ft
from rsn_torch.kernels import proposal_forward as pf
from rsn_torch.models import proposal as proposal_lib
from rsn_torch.models.field import DENSITY_BIAS, Field, get_reflection
from rsn_torch.models.proposal import ProposalField


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    compute_dtype: torch.dtype
    sh_l8_m7_2x: bool
    use_kernels: bool        # K1/K2 for every render field evaluation
    use_train_kernels: bool  # FusedFieldTrain when training
    save_acts: bool          # its spill route (K3-K5), else the recompute
                             # route (K7, K1 at the train width, K8)


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """K1's and K2's packed weights, and K9's when the render takes the
    proposal kernel (pack_kernel_operands)."""
    v3f: Tuple[torch.Tensor, ...]
    density: Tuple[torch.Tensor, ...]
    proposal: Optional[Tuple[torch.Tensor, ...]] = None


@dataclasses.dataclass(frozen=True)
class TrainOperands:
    """FusedFieldTrain's operands: the fp32 packing under autograd and the
    density head row (the normals' seed)."""
    packed_f32: Tuple[torch.Tensor, ...]
    wd_row: torch.Tensor


def _field_cfg(cfg: ModelConfig) -> FieldConfig:
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    use_kernels = cfg.use_pallas and dtype == torch.bfloat16
    use_train_kernels = use_kernels and cfg.use_pallas_train
    return FieldConfig(compute_dtype=dtype,
                       sh_l8_m7_2x=cfg.bug_compat.sh_l8_m7_2x,
                       use_kernels=use_kernels,
                       use_train_kernels=use_train_kernels,
                       save_acts=use_train_kernels and cfg.use_pallas_acts)


def _use_prop_kernel(cfg: ModelConfig, fcfg: FieldConfig) -> bool:
    """K9 on the render path (rsn: use_pallas, bf16, use_pallas_proposal)."""
    return fcfg.use_kernels and cfg.use_pallas_proposal


def pack_kernel_operands(field: Field, cfg: ModelConfig,
                         proposal: Optional[ProposalField] = None
                         ) -> Optional[KernelOperands]:
    """The kernels' packed weights, or None when `cfg` takes the plain
    field.  A caller that renders many chunks packs once and passes the
    result to every get_outputs call."""
    fcfg = _field_cfg(cfg)
    if not fcfg.use_kernels:
        return None
    prop = (pf.pack_prop_params(proposal)
            if proposal is not None and _use_prop_kernel(cfg, fcfg)
            else None)
    return KernelOperands(ff.pack_params_v3f(field),
                          ff.pack_params_density(field), prop)


def pack_train_operands(field: Field) -> TrainOperands:
    return TrainOperands(ff.pack_params_v3f_f32(field), ft.density_row(field))


def apply_collider(ray_bundle: RayBundle, cfg: ModelConfig) -> RayBundle:
    """NearFarCollider: constant near / far planes."""
    ones = torch.ones_like(ray_bundle.origins[..., :1])
    return dataclasses.replace(ray_bundle,
                               nears=ones * cfg.collider_near_plane,
                               fars=ones * cfg.collider_far_plane)


def _eval_field(field: Field, ray_samples: RaySamples, fcfg: FieldConfig,
                packed, training: bool = False, want_normals: bool = False,
                want_dmc: bool = True):
    """One field evaluation of a pass: contraction + trunk + heads +
    factored mid branch -> (f, mean, cov_diag).  The kernel branches
    return the (R, S, C) kernel output as f["_out"] and no mean /
    cov_diag; the eval composites read it as (R, S) column planes.  The
    training kernel branch also returns the analytic normals of K3's
    V4_DPDM columns (want_normals).  want_dmc=False promises that this
    pass's mean/cov cotangent is dead (rays that are autograd leaves)."""
    ray_dirs = ray_samples.directions[..., 0, :]
    train_kernels = training and fcfg.use_train_kernels
    if (fcfg.use_kernels and not training) or train_kernels:
        R, S = ray_samples.starts.shape[:2]
        mc = packed_contract_planes(ray_samples, ff.IN_COLS)
        if train_kernels:
            g = ff.mid_g_bands_f32(field, ray_dirs, fcfg.sh_l8_m7_2x)
            out = ft.fused_field_train(packed.packed_f32, mc, g, S,
                                       want_normals, want_dmc,
                                       packed.wd_row, fcfg.save_acts)
        else:
            g = ff.mid_g_bands(field, ray_dirs, fcfg.sh_l8_m7_2x)
            out = ff.field_forward_v3(packed.v3f, mc, g, S)
        out = out.reshape(R, S, -1)
        preact = out[..., ff.V3_DENSITY:ff.V3_DENSITY + 1].float()
        f = {
            "density": F.softplus(preact + DENSITY_BIAS),
            "diff": out[..., ff.V3_DIFF].float(),
            "tint": out[..., ff.V3_TINT].float(),
            "rough_raw": out[..., ff.V3_ROUGH:ff.V3_ROUGH + 1].float(),
            "pred_normals": normalize(-out[..., ff.V3_NORMALS].float()),
            "mid_out": out[..., ff.V3_MID].float(),
            "_out": out,
        }
        if train_kernels and want_normals:
            f["normals"] = (-normalize(out[..., ft.V4_DPDM].float())).detach()
        return f, None, None
    mean, cov_diag = contract_blob(get_gaussian_blob(ray_samples))
    f = field.get_field_outputs(mean, cov_diag, fcfg.compute_dtype)
    rough_sp = F.softplus(f["rough_raw"]).detach()
    mid = field.get_mid_factored(ray_dirs, rough_sp, f["bottleneck"],
                                 fcfg.sh_l8_m7_2x, fcfg.compute_dtype)
    f["mid_out"] = f["diff"] + f["tint"] * mid
    return f, mean, cov_diag


def _weights_from_planes(out_planes: torch.Tensor,
                         ray_samples: RaySamples) -> torch.Tensor:
    """(R, S) compositing weights from K1's density column."""
    dens = F.softplus(out_planes[..., ff.V3_DENSITY].float() + DENSITY_BIAS)
    deltas = (ray_samples.ends - ray_samples.starts)[..., 0]
    return weights_planes(dens, deltas)


def _density_pass(field: Field, ray_samples: RaySamples, fcfg: FieldConfig,
                  packed: Optional[KernelOperands]) -> torch.Tensor:
    """Density-only field evaluation -> (R, S) compositing weights,
    bit-identical to the full evaluation's (same IPE, trunk and density
    column: K2 on the kernel branch, get_density on flattened rows on
    the plain branch)."""
    if fcfg.use_kernels:
        R, S = ray_samples.starts.shape[:2]
        mc = packed_contract_planes(ray_samples, ff.IN_COLS)
        out = ff.field_forward_density(packed.density, mc)
        dens = F.softplus(out.reshape(R, S, ff.DENS_COLS)[..., 0].float()
                          + DENSITY_BIAS)
        deltas = (ray_samples.ends - ray_samples.starts)[..., 0]
        return weights_planes(dens, deltas)
    mean, cov_diag = contract_blob(get_gaussian_blob(ray_samples))
    shape = mean.shape[:-1]
    density, _, _ = field.get_density(mean.reshape(-1, 3),
                                      cov_diag.reshape(-1, 3),
                                      fcfg.compute_dtype)
    return ray_samples.get_weights(density.reshape(*shape, 1))[..., 0]


def _primary_pass(field: Field, ray_samples: RaySamples, fcfg: FieldConfig,
                  packed, training: bool = False, rays_live: bool = True):
    """Passes 1 and 2: field evaluation + per-sample heads.  Training
    adds the analytic-normals target (K3's in-kernel dgrad, or autograd
    on the plain branch)."""
    f, mean, cov_diag = _eval_field(field, ray_samples, fcfg, packed,
                                    training, want_normals=training,
                                    want_dmc=rays_live)
    out_planes = f.get("_out") if not training else None
    if out_planes is not None:
        weights = _weights_from_planes(out_planes, ray_samples)[..., None]
    else:
        weights = ray_samples.get_weights(f["density"])
    pred_normals = f["pred_normals"]
    if training:
        normals = f.get("normals")
        if normals is None:
            normals = field.get_analytic_normals(mean, cov_diag,
                                                 fcfg.compute_dtype)
    else:
        normals = pred_normals.detach()
    # the ray directions are leaves: the orientation loss trains the
    # normals head only
    _, n_dot_d = get_reflection(ray_samples.directions.detach(),
                                pred_normals)
    return dict(weights=weights, rough_raw=f["rough_raw"],
                pred_normals=pred_normals, normals=normals,
                n_dot_d=n_dot_d, diff=f["diff"],
                tint=f["tint"], mid=f["mid_out"], out_planes=out_planes)


def _reflect_pass(field: Field, ray_samples: RaySamples, bg_color,
                  fcfg: FieldConfig, packed, training: bool = False):
    """Passes 3 and 4: reflected radiance -> (weights, composite); the
    weights are detached."""
    f, _, _ = _eval_field(field, ray_samples, fcfg, packed, training)
    out = f.get("_out") if not training else None
    if out is not None:
        wS = _weights_from_planes(out, ray_samples)
        composited = render_rgb_planes(
            wS, [out[..., c].float() for c in range(3)],
            background_color=bg_color, training=False)
        return wS[..., None], composited
    weights = ray_samples.get_weights(f["density"]).detach()
    return weights, render_rgb(f["mid_out"], weights,
                               background_color=bg_color, training=training)


def get_outputs(field: Field, ray_bundle: RayBundle, cfg: ModelConfig,
                training: bool = False, need_coarse_rgb: bool = True,
                generator: Optional[torch.Generator] = None,
                packed: Optional[KernelOperands] = None,
                rays_live: bool = True,
                proposal: Optional[ProposalField] = None,
                prop_anneal: Optional[float] = None
                ) -> Dict[str, torch.Tensor]:
    """The 4-pass render; ray_bundle must already be collided.

    training=False: the eval render, under torch.no_grad().
    need_coarse_rgb=False (product renders: only final_rgb, accumulation
    and depth are consumed) runs passes 1 and 3 density-only; every
    downstream output is unchanged, mid_rgb_coarse becomes the
    background fill and mid_reflect_coarse is omitted.

    training=True: the training forward under autograd, with stratified
    draws from `generator` (None: the eval midpoints) and the
    reflect_ray_fraction compaction cap.  rays_live: whether the rays'
    geometry carries live gradients (the camera optimizer's pose deltas
    reach the bundle's origins and directions); the trainer passes False
    when the camera optimizer is off, which lets the primary passes'
    backward on the spill route skip the dead IPE backward (K5 instead
    of K4).

    generator: also draws the per-ray background of the tint composite
    when cfg.bug_compat.tint_random_background is set (off by default).
    packed: pack_kernel_operands(field, cfg, proposal), when the caller
    already holds it (eval only); packed here otherwise.

    proposal: the preset's ProposalField; with cfg.use_proposal it runs
    pass 1 (and pass 3 with cfg.use_proposal_reflect), and the outputs
    carry the interlevel and distortion losses' inputs.  Without one, a
    use_proposal config runs the main field's coarse pass, as rsn does.
    prop_anneal: the exponent a of the sampling histogram w**a (w > 0),
    mip-NeRF-360's weight anneal; None is off.  Only the histogram the
    fine passes resample from is annealed."""
    fcfg = _field_cfg(cfg)
    if training:
        train_ops = (pack_train_operands(field) if fcfg.use_train_kernels
                     else None)
        return _get_outputs(field, ray_bundle, cfg, fcfg, True, True,
                            generator, train_ops, rays_live, proposal,
                            prop_anneal)
    with torch.no_grad():
        if packed is None:
            packed = pack_kernel_operands(field, cfg, proposal)
        return _get_outputs(field, ray_bundle, cfg, fcfg, False,
                            need_coarse_rgb, generator, packed, True,
                            proposal, prop_anneal)


def _anneal(w: torch.Tensor, a: Optional[float]) -> torch.Tensor:
    """The sampling histogram w**a; w == 0 stays 0 (0**0 would be 1)."""
    if a is None:
        return w
    return torch.where(w > 0.0, w ** a, torch.zeros_like(w))


def _get_outputs(field, ray_bundle, cfg, fcfg, training, need_coarse_rgb,
                 generator, packed, rays_live, proposal, prop_anneal):
    uniform = identity_spacing()
    wht = white(ray_bundle.origins.device)
    strat = generator if training else None
    use_prop = cfg.use_proposal and proposal is not None

    def prop_density(rs: RaySamples) -> torch.Tensor:
        """The proposal density: K9 on the render path, else the fp32
        composition (under autograd when training)."""
        if not training and _use_prop_kernel(cfg, fcfg):
            return pf.proposal_density_kernel(packed.proposal, rs)
        return proposal_lib.proposal_density(proposal, rs)

    # ---- pass 1: coarse ----
    c = None
    if use_prop:
        rs_uniform = spaced_sample(ray_bundle, uniform,
                                   cfg.num_proposal_samples, generator=strat)
        w_prop = rs_uniform.get_weights(prop_density(rs_uniform))
        coarse_weights = w_prop.detach()
        sampling_weights = _anneal(coarse_weights, prop_anneal)
        accumulation_coarse = render_accumulation(coarse_weights)
        depth_coarse = render_depth_median(coarse_weights, rs_uniform.starts,
                                           rs_uniform.ends)
        # no coarse rgb in proposal mode: the background fill
        mid_rgb_coarse = wht * (1.0 - accumulation_coarse)
    elif not need_coarse_rgb:
        rs_uniform = spaced_sample(ray_bundle, uniform,
                                   cfg.num_coarse_samples, generator=strat)
        wS = _density_pass(field, rs_uniform, fcfg, packed)
        coarse_weights = sampling_weights = wS[..., None]
        accumulation_coarse = wS.sum(dim=-1, keepdim=True)
        depth_coarse = render_depth_median_planes(
            wS, rs_uniform.starts[..., 0], rs_uniform.ends[..., 0])
        mid_rgb_coarse = wht * (1.0 - accumulation_coarse)
    else:
        rs_uniform = spaced_sample(ray_bundle, uniform,
                                   cfg.num_coarse_samples, generator=strat)
        c = _primary_pass(field, rs_uniform, fcfg, packed, training,
                          rays_live)
        coarse_weights = sampling_weights = c["weights"]
        if c["out_planes"] is not None:
            wS = coarse_weights[..., 0]
            accumulation_coarse = wS.sum(dim=-1, keepdim=True)
            depth_coarse = render_depth_median_planes(
                wS, rs_uniform.starts[..., 0], rs_uniform.ends[..., 0])
            mid_rgb_coarse = render_rgb_planes(
                wS, [c["out_planes"][..., i].float() for i in range(3)],
                wht, training=False)
        else:
            accumulation_coarse = render_accumulation(coarse_weights)
            depth_coarse = render_depth_median(
                coarse_weights, rs_uniform.starts, rs_uniform.ends)
            mid_rgb_coarse = render_rgb(c["mid"], coarse_weights, wht,
                                        training=training).clamp(0.0, 1.0)

    # ---- pass 2: fine ----
    rs_pdf = pdf_sample(ray_bundle, rs_uniform, sampling_weights, uniform,
                        cfg.num_importance_samples, generator=strat)
    f = _primary_pass(field, rs_pdf, fcfg, packed, training, rays_live)
    tint_bg = "random" if cfg.bug_compat.tint_random_background else None
    if f["out_planes"] is not None:
        out = f["out_planes"]
        wS = f["weights"][..., 0]
        accumulation_fine = wS.sum(dim=-1, keepdim=True)
        depth_fine = render_depth_median_planes(
            wS, rs_pdf.starts[..., 0], rs_pdf.ends[..., 0])

        def planes(cols):
            return [out[..., i].float() for i in range(cols.start, cols.stop)]

        mid_rgb_fine = render_rgb_planes(wS, planes(ff.V3_MID), wht,
                                         training=False)
        diff_fine = render_rgb_planes(wS, planes(ff.V3_DIFF), wht,
                                      training=False)
        tint_fine = render_rgb_planes(wS, planes(ff.V3_TINT), tint_bg,
                                      generator=generator, training=False)
        nraw = [-p for p in planes(ff.V3_NORMALS)]
        nnorm = safe_sqrt(nraw[0] ** 2 + nraw[1] ** 2
                          + nraw[2] ** 2).clamp_min(1e-12)
        pred_normals_fine = torch.cat(
            composite_planes(wS, *[p / nnorm for p in nraw]), dim=-1)
        (roughness,) = composite_planes(
            wS, torch.sigmoid(out[..., ff.V3_ROUGH].float()))
    else:
        accumulation_fine = render_accumulation(f["weights"])
        depth_fine = render_depth_median(f["weights"], rs_pdf.starts,
                                         rs_pdf.ends)
        mid_rgb_fine = render_rgb(f["mid"], f["weights"], wht,
                                  training=training).clamp(0.0, 1.0)
        diff_fine = render_rgb(f["diff"], f["weights"], wht,
                               training=training)
        tint_fine = render_rgb(f["tint"], f["weights"], tint_bg,
                               generator=generator, training=training)
        pred_normals_fine = render_normals(f["pred_normals"], f["weights"])
        roughness = render_scalar(torch.sigmoid(f["rough_raw"]),
                                  f["weights"])  # live gradient
    diff_fine = diff_fine.detach()
    tint_fine = tint_fine.detach()
    pred_normals_fine = pred_normals_fine.detach()
    n_dot_d = (pred_normals_fine * ray_bundle.directions).sum(
        dim=-1, keepdim=True).detach()
    mask = ((accumulation_fine > cfg.mask_accumulation_threshold)
            & (n_dot_d < 0)).reshape(-1)

    zero = torch.zeros((), device=mask.device)
    outputs = {
        "mid_rgb_coarse": mid_rgb_coarse,
        "mid_rgb_fine": mid_rgb_fine,
        "accumulation_coarse": accumulation_coarse.detach(),
        "accumulation_fine": accumulation_fine.detach(),
        "depth_coarse": depth_coarse.detach(),
        "depth_fine": depth_fine.detach(),
        "weights_coarse": coarse_weights.detach(),
        "weights_fine": f["weights"].detach(),
        "pred_normals_fine": f["pred_normals"],
        "normals_fine": f["normals"].detach(),
        "n_dot_d_fine": f["n_dot_d"],
        "diff": diff_fine,
        "tint": tint_fine,
        "roughness": roughness,
        "mask": mask,
        # share of rays masked but beyond the compaction cap
        "reflect_overflow": zero,
    }
    if use_prop:
        # the interlevel loss's inputs: the LIVE proposal weights and both
        # spacing-domain histograms
        outputs["prop_weights"] = w_prop
        outputs["prop_spacing_bins"] = rs_uniform.spacing_bins()
        outputs["fine_spacing_bins"] = rs_pdf.spacing_bins()
        if cfg.distortion_loss_mult:
            # on the LIVE fine weights: it reaches the main field's density
            outputs["distortion"] = proposal_lib.distortion_per_ray(
                f["weights"], outputs["fine_spacing_bins"])[..., None]
    elif c is not None:
        outputs.update({"pred_normals_coarse": c["pred_normals"],
                        "normals_coarse": c["normals"].detach(),
                        "n_dot_d_coarse": c["n_dot_d"]})
    if not cfg.use_reflection:
        return outputs

    # ---- reflected ray bundle ----
    origins = (ray_bundle.origins + depth_fine * ray_bundle.directions
               ).detach()
    reflections = normalize(ray_bundle.directions
                            - 2.0 * n_dot_d * pred_normals_fine).detach()
    sqradius = 2.0 * n_dot_d.abs() * roughness ** 2  # live via roughness
    near = 0.0 if cfg.bug_compat.reflect_near_zero else cfg.reflect_near
    ones = torch.ones_like(depth_fine)
    reflect_bundle = RayBundle(origins=origins, directions=reflections,
                               pixel_area=torch.pi * sqradius,
                               nears=ones * near,
                               fars=ones * cfg.reflect_far)

    # Fixed-shape compaction: with a fraction < 1 (training's
    # reflect_ray_fraction, eval's eval_reflect_ray_fraction), passes 3
    # and 4 run on K rays picked by a stable descending sort of the mask
    # (lower indices first among ties, like jax.lax.top_k); exact
    # whenever #masked <= K, the rest report "reflect_overflow".
    R = mask.shape[0]
    frac = (cfg.reflect_ray_fraction if training
            else cfg.eval_reflect_ray_fraction)
    K = R if frac >= 1.0 else min(R, max(8, int(R * frac)))
    sel = None
    mask_col = mask[:, None]
    if K < R:
        sel = torch.sort(mask.float(), descending=True,
                         stable=True).indices[:K]
        reflect_bundle = reflect_bundle.index(sel)
        sqradius, reflections = sqradius[sel], reflections[sel]
        selected = torch.zeros(R, dtype=torch.bool, device=mask.device)
        selected[sel] = True
        mask_col = (mask & selected)[:, None]
        outputs["reflect_overflow"] = (mask & ~selected).float().mean()
    background_color = field.get_inf_color(reflections, sqradius,
                                           fcfg.compute_dtype)

    # ---- pass 3: reflected coarse ----
    recip = reciprocal_spacing(cfg.reciprocal_tan)
    rs_recip = spaced_sample(reflect_bundle, recip,
                             cfg.num_reflect_coarse_samples, generator=strat)
    bg_fill = wht * (1.0 - accumulation_fine)  # live accumulation

    def scatter(sub: torch.Tensor, width: int) -> torch.Tensor:
        if sel is None:
            return sub
        full = torch.zeros((R, width), dtype=sub.dtype, device=sub.device)
        return full.index_put((sel,), sub)

    def scatter_reflect(composited_sub: torch.Tensor) -> torch.Tensor:
        inner = scatter(composited_sub, 3)
        return torch.where(
            mask_col, (diff_fine + tint_fine * inner).clamp(0.0, 1.0),
            bg_fill)

    use_prop_reflect = use_prop and cfg.use_proposal_reflect
    if use_prop_reflect:
        # the proposal places pass 4's samples.  It sees DETACHED geometry:
        # rs_recip's pixel_area is live through the roughness, and the
        # interlevel loss keeps w_refl_prop live, so without the detach it
        # would train the main field's roughness head
        rs_recip_sg = RaySamples(*(getattr(rs_recip, fl.name).detach()
                                   for fl in dataclasses.fields(rs_recip)))
        w_refl_prop = rs_recip_sg.get_weights(prop_density(rs_recip_sg))
        w_refl_coarse = _anneal(w_refl_prop.detach(), prop_anneal)
    elif not need_coarse_rgb:
        w_refl_coarse = _density_pass(field, rs_recip, fcfg, packed)[..., None]
    else:
        w_refl_coarse, mid_reflect_coarse_in = _reflect_pass(
            field, rs_recip, background_color, fcfg, packed, training)
        outputs["mid_reflect_coarse"] = scatter_reflect(mid_reflect_coarse_in)

    # ---- pass 4: reflected fine ----
    rs_refl_pdf = pdf_sample(reflect_bundle, rs_recip, w_refl_coarse, recip,
                             cfg.num_reflect_importance_samples,
                             generator=strat)
    w_refl_fine, mid_reflect_fine_in = _reflect_pass(
        field, rs_refl_pdf, background_color, fcfg, packed, training)
    depth_sub = render_depth_median(w_refl_fine, rs_refl_pdf.starts,
                                    rs_refl_pdf.ends)
    outputs["mid_reflect_fine"] = scatter_reflect(mid_reflect_fine_in)
    # valid only where mask (SURVEY B#10)
    outputs["depth_reflect_fine"] = scatter(depth_sub, 1)
    if use_prop_reflect:
        # the second interlevel term's inputs, on the reflected K-subset
        # (reciprocal spacing domain); w_refl_fine is detached
        outputs["reflect_prop_weights"] = w_refl_prop
        outputs["reflect_prop_spacing_bins"] = rs_recip.spacing_bins()
        outputs["reflect_fine_spacing_bins"] = rs_refl_pdf.spacing_bins()
        outputs["reflect_weights_fine"] = w_refl_fine
    return outputs


def final_rgb(outputs):
    """The product image: the reflection-composited fine rgb, or the
    plain fine rgb in primary-only (use_reflection=False) mode."""
    return outputs.get("mid_reflect_fine", outputs["mid_rgb_fine"])


# Loss keys by gradient route (rsn.models.model): pose gradients would
# flow only from the photometric losses; every key get_loss_dict emits
# is in exactly one set.
PHOTOMETRIC_LOSS_KEYS = frozenset({
    "loss_mid_coarse", "loss_mid_fine",
    "loss_reflect_mid_coarse", "loss_reflect_mid_fine",
})
NON_PHOTOMETRIC_LOSS_KEYS = frozenset({
    "predicted_normal_loss_coarse", "predicted_normal_loss_fine",
    "orientation_loss_coarse", "orientation_loss_fine",
    "interlevel_loss", "distortion_loss",
})


def get_loss_dict(outputs: Dict[str, torch.Tensor], gt_image: torch.Tensor,
                  coefficients: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """The 8 active losses of the reference model, scaled by
    `coefficients` (rsn.models.model.get_loss_dict); in proposal mode the
    coarse and reflect-coarse terms give way to "interlevel_loss" (and
    "distortion_loss" with distortion_loss_mult).  gt_image: (R, 3) or
    (R, 4); RGBA is blended against white."""
    def mse(a, b):
        return ((a - b) ** 2).mean()

    pred_mid_coarse, gt_rgb = blend_background_for_loss_computation(
        outputs["mid_rgb_coarse"], outputs["accumulation_coarse"], gt_image)
    losses = {
        "loss_mid_fine": mse(gt_rgb, outputs["mid_rgb_fine"]),
        # sums, not means; weights and normals detached, pred_normals and
        # n_dot_d live
        "predicted_normal_loss_fine": (outputs["weights_fine"] * (
            (outputs["normals_fine"] - outputs["pred_normals_fine"]) ** 2
        ).sum(dim=-1, keepdim=True)).sum(),
        "orientation_loss_fine": (outputs["weights_fine"] * torch.relu(
            outputs["n_dot_d_fine"]) ** 2).sum(),
    }
    if "mid_reflect_fine" in outputs:  # absent in primary-only mode
        losses["loss_reflect_mid_fine"] = mse(gt_rgb,
                                              outputs["mid_reflect_fine"])
        if "mid_reflect_coarse" in outputs:
            losses["loss_reflect_mid_coarse"] = mse(
                gt_rgb, outputs["mid_reflect_coarse"])
    if "prop_weights" in outputs:
        # proposal mode: no coarse rgb or normal heads; the proposal field
        # trains on the interlevel loss (one term per proposal pass)
        interlevel = proposal_lib.interlevel_loss(
            outputs["weights_fine"], outputs["fine_spacing_bins"],
            outputs["prop_weights"], outputs["prop_spacing_bins"])
        if "reflect_prop_weights" in outputs:
            interlevel = interlevel + proposal_lib.interlevel_loss(
                outputs["reflect_weights_fine"],
                outputs["reflect_fine_spacing_bins"],
                outputs["reflect_prop_weights"],
                outputs["reflect_prop_spacing_bins"])
        losses["interlevel_loss"] = interlevel
        if "distortion" in outputs:
            losses["distortion_loss"] = outputs["distortion"].mean()
    else:
        losses.update({
            "loss_mid_coarse": mse(gt_rgb, pred_mid_coarse),
            "predicted_normal_loss_coarse": (outputs["weights_coarse"] * (
                (outputs["normals_coarse"] - outputs["pred_normals_coarse"])
                ** 2).sum(dim=-1, keepdim=True)).sum(),
            "orientation_loss_coarse": (outputs["weights_coarse"]
                                        * torch.relu(outputs["n_dot_d_coarse"])
                                        ** 2).sum(),
        })
    # strict lookup: a missing coefficient is an error, not a default
    return {k: v * coefficients[k] for k, v in losses.items()}
