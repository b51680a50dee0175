"""The 4-pass reflect-sampling NeRF renderer, eval mode (port of the eval
path of rsn.models.model.get_outputs).

  pass 1 coarse:          128 uniform samples in [near=2, far=6]
  pass 2 fine:            128 PDF samples from the coarse weights
  pass 3 reflect coarse:  64 reciprocal-spaced samples on the secondary
                          rays spawned at the fine median depth
  pass 4 reflect fine:    64 PDF samples from the pass-3 weights

With compute_dtype "bfloat16" and cfg.use_pallas, every full field
evaluation goes through K1 and every density-only one through K2
(rsn_torch.kernels.field_forward); the wrappers launch the CUDA kernels
for CUDA tensors and run their plain versions for CPU tensors.  Other
configs run the plain field (rsn_torch.models.field).

Training, the proposal sampler and meshes are later steps of the port
(ROADMAP.md): asking for them raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rsn.configs import ModelConfig
from rsn_torch.core.contract import contract_blob, packed_contract_planes
from rsn_torch.core.rays import RayBundle, RaySamples, get_gaussian_blob
from rsn_torch.core.render import (composite_planes, normalize,
                                   render_accumulation, render_depth_median,
                                   render_depth_median_planes, render_normals,
                                   render_rgb, render_rgb_planes,
                                   render_scalar, safe_sqrt, weights_planes,
                                   white)
from rsn_torch.core.sampling import pdf_sample
from rsn_torch.core.spacing import (identity_spacing, reciprocal_spacing,
                                    spaced_sample)
from rsn_torch.kernels import field_forward as ff
from rsn_torch.models.field import DENSITY_BIAS, Field, get_reflection


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    compute_dtype: torch.dtype
    sh_l8_m7_2x: bool
    use_kernels: bool  # K1/K2 for every field evaluation (bf16 only)


@dataclasses.dataclass(frozen=True)
class KernelOperands:
    """K1's and K2's packed weights (pack_kernel_operands)."""
    v3f: Tuple[torch.Tensor, ...]
    density: Tuple[torch.Tensor, ...]


def _field_cfg(cfg: ModelConfig) -> FieldConfig:
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return FieldConfig(compute_dtype=dtype,
                       sh_l8_m7_2x=cfg.bug_compat.sh_l8_m7_2x,
                       use_kernels=cfg.use_pallas and dtype == torch.bfloat16)


def pack_kernel_operands(field: Field, cfg: ModelConfig
                         ) -> Optional[KernelOperands]:
    """The kernels' packed weights, or None when `cfg` takes the plain
    field.  A caller that renders many chunks packs once and passes the
    result to every get_outputs call."""
    if not _field_cfg(cfg).use_kernels:
        return None
    return KernelOperands(ff.pack_params_v3f(field),
                          ff.pack_params_density(field))


def apply_collider(ray_bundle: RayBundle, cfg: ModelConfig) -> RayBundle:
    """NearFarCollider: constant near / far planes."""
    ones = torch.ones_like(ray_bundle.origins[..., :1])
    return dataclasses.replace(ray_bundle,
                               nears=ones * cfg.collider_near_plane,
                               fars=ones * cfg.collider_far_plane)


def _eval_field(field: Field, ray_samples: RaySamples, fcfg: FieldConfig,
                packed: Optional[KernelOperands]) -> Dict[str, torch.Tensor]:
    """One field evaluation of a pass: contraction + trunk + heads +
    factored mid branch.  The kernel branch also returns the raw
    (R, S, 16) K1 output as "_out", which the eval composites read as
    (R, S) column planes."""
    ray_dirs = ray_samples.directions[..., 0, :]
    if fcfg.use_kernels:
        R, S = ray_samples.starts.shape[:2]
        mc = packed_contract_planes(ray_samples, ff.IN_COLS)
        g = ff.mid_g_bands(field, ray_dirs, fcfg.sh_l8_m7_2x)
        out = ff.field_forward_v3(packed.v3f, mc, g, S).reshape(R, S, -1)
        preact = out[..., ff.V3_DENSITY:ff.V3_DENSITY + 1].float()
        return {
            "density": F.softplus(preact + DENSITY_BIAS),
            "diff": out[..., ff.V3_DIFF].float(),
            "tint": out[..., ff.V3_TINT].float(),
            "rough_raw": out[..., ff.V3_ROUGH:ff.V3_ROUGH + 1].float(),
            "pred_normals": normalize(-out[..., ff.V3_NORMALS].float()),
            "mid_out": out[..., ff.V3_MID].float(),
            "_out": out,
        }
    mean, cov_diag = contract_blob(get_gaussian_blob(ray_samples))
    f = field.get_field_outputs(mean, cov_diag, fcfg.compute_dtype)
    rough_sp = F.softplus(f["rough_raw"])
    mid = field.get_mid_factored(ray_dirs, rough_sp, f["bottleneck"],
                                 fcfg.sh_l8_m7_2x, fcfg.compute_dtype)
    f["mid_out"] = f["diff"] + f["tint"] * mid
    return f


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
                  packed: Optional[KernelOperands]):
    """Passes 1 and 2: field evaluation + per-sample heads."""
    f = _eval_field(field, ray_samples, fcfg, packed)
    out_planes = f.get("_out")
    if out_planes is not None:
        weights = _weights_from_planes(out_planes, ray_samples)[..., None]
    else:
        weights = ray_samples.get_weights(f["density"])
    pred_normals = f["pred_normals"]
    _, n_dot_d = get_reflection(ray_samples.directions, pred_normals)
    return dict(weights=weights, rough_raw=f["rough_raw"],
                pred_normals=pred_normals, normals=pred_normals,
                n_dot_d=n_dot_d, diff=f["diff"],
                tint=f["tint"], mid=f["mid_out"], out_planes=out_planes)


def _reflect_pass(field: Field, ray_samples: RaySamples, bg_color,
                  fcfg: FieldConfig, packed: Optional[KernelOperands]):
    """Passes 3 and 4: reflected radiance -> (weights, composite)."""
    f = _eval_field(field, ray_samples, fcfg, packed)
    out = f.get("_out")
    if out is not None:
        wS = _weights_from_planes(out, ray_samples)
        composited = render_rgb_planes(
            wS, [out[..., c].float() for c in range(3)],
            background_color=bg_color, training=False)
        return wS[..., None], composited
    weights = ray_samples.get_weights(f["density"])
    return weights, render_rgb(f["mid_out"], weights,
                               background_color=bg_color, training=False)


@torch.no_grad()
def get_outputs(field: Field, ray_bundle: RayBundle, cfg: ModelConfig,
                training: bool = False, need_coarse_rgb: bool = True,
                generator: Optional[torch.Generator] = None,
                packed: Optional[KernelOperands] = None
                ) -> Dict[str, torch.Tensor]:
    """The eval-mode 4-pass render; ray_bundle must already be collided.

    need_coarse_rgb=False (product renders: only final_rgb, accumulation
    and depth are consumed) runs passes 1 and 3 density-only; every
    downstream output is unchanged, mid_rgb_coarse becomes the
    background fill and mid_reflect_coarse is omitted.

    generator: draws the per-ray background of the tint composite when
    cfg.bug_compat.tint_random_background is set (off by default).
    packed: pack_kernel_operands(field, cfg), when the caller already
    holds it; packed here otherwise."""
    if training:
        raise NotImplementedError(
            "training forward: ROADMAP Queue 1 steps 6-7 (train kernels "
            "K3-K6 and the trainer) are not ported yet")
    if cfg.use_proposal:
        raise NotImplementedError(
            "proposal sampling: ROADMAP Queue 1 step 14 (preset slice) is "
            "not ported yet")
    fcfg = _field_cfg(cfg)
    if packed is None:
        packed = pack_kernel_operands(field, cfg)
    uniform = identity_spacing()
    wht = white(ray_bundle.origins.device)

    # ---- pass 1: coarse ----
    rs_uniform = spaced_sample(ray_bundle, uniform, cfg.num_coarse_samples)
    c = None
    if not need_coarse_rgb:
        wS = _density_pass(field, rs_uniform, fcfg, packed)
        coarse_weights = wS[..., None]
        accumulation_coarse = wS.sum(dim=-1, keepdim=True)
        depth_coarse = render_depth_median_planes(
            wS, rs_uniform.starts[..., 0], rs_uniform.ends[..., 0])
        mid_rgb_coarse = wht * (1.0 - accumulation_coarse)
    else:
        c = _primary_pass(field, rs_uniform, fcfg, packed)
        coarse_weights = c["weights"]
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
                                        training=False).clamp(0.0, 1.0)

    # ---- pass 2: fine ----
    rs_pdf = pdf_sample(ray_bundle, rs_uniform, coarse_weights, uniform,
                        cfg.num_importance_samples)
    f = _primary_pass(field, rs_pdf, fcfg, packed)
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
                                  training=False).clamp(0.0, 1.0)
        diff_fine = render_rgb(f["diff"], f["weights"], wht, training=False)
        tint_fine = render_rgb(f["tint"], f["weights"], tint_bg,
                               generator=generator, training=False)
        pred_normals_fine = render_normals(f["pred_normals"], f["weights"])
        roughness = render_scalar(torch.sigmoid(f["rough_raw"]),
                                  f["weights"])
    n_dot_d = (pred_normals_fine * ray_bundle.directions).sum(
        dim=-1, keepdim=True)
    mask = ((accumulation_fine > cfg.mask_accumulation_threshold)
            & (n_dot_d < 0)).reshape(-1)

    zero = torch.zeros((), device=mask.device)
    outputs = {
        "mid_rgb_coarse": mid_rgb_coarse,
        "mid_rgb_fine": mid_rgb_fine,
        "accumulation_coarse": accumulation_coarse,
        "accumulation_fine": accumulation_fine,
        "depth_coarse": depth_coarse,
        "depth_fine": depth_fine,
        "weights_coarse": coarse_weights,
        "weights_fine": f["weights"],
        "pred_normals_fine": f["pred_normals"],
        "normals_fine": f["normals"],
        "n_dot_d_fine": f["n_dot_d"],
        "diff": diff_fine,
        "tint": tint_fine,
        "roughness": roughness,
        "mask": mask,
        # share of rays masked but beyond the compaction cap
        "reflect_overflow": zero,
    }
    if c is not None:
        outputs.update({"pred_normals_coarse": c["pred_normals"],
                        "normals_coarse": c["normals"],
                        "n_dot_d_coarse": c["n_dot_d"]})
    if not cfg.use_reflection:
        return outputs

    # ---- reflected ray bundle ----
    origins = ray_bundle.origins + depth_fine * ray_bundle.directions
    reflections = normalize(ray_bundle.directions
                            - 2.0 * n_dot_d * pred_normals_fine)
    sqradius = 2.0 * n_dot_d.abs() * roughness ** 2
    near = 0.0 if cfg.bug_compat.reflect_near_zero else cfg.reflect_near
    ones = torch.ones_like(depth_fine)
    reflect_bundle = RayBundle(origins=origins, directions=reflections,
                               pixel_area=torch.pi * sqradius,
                               nears=ones * near,
                               fars=ones * cfg.reflect_far)

    # Fixed-shape compaction: with eval_reflect_ray_fraction < 1, passes
    # 3 and 4 run on K rays picked by a stable descending sort of the
    # mask (lower indices first among ties, like jax.lax.top_k); exact
    # whenever #masked <= K, the rest report "reflect_overflow".
    R = mask.shape[0]
    frac = cfg.eval_reflect_ray_fraction
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
                             cfg.num_reflect_coarse_samples)
    bg_fill = wht * (1.0 - accumulation_fine)

    def scatter_reflect(composited_sub: torch.Tensor) -> torch.Tensor:
        inner = composited_sub
        if sel is not None:
            inner = torch.zeros((R, 3), dtype=composited_sub.dtype,
                                device=composited_sub.device)
            inner[sel] = composited_sub
        return torch.where(
            mask_col, (diff_fine + tint_fine * inner).clamp(0.0, 1.0),
            bg_fill)

    if not need_coarse_rgb:
        w_refl_coarse = _density_pass(field, rs_recip, fcfg, packed)[..., None]
    else:
        w_refl_coarse, mid_reflect_coarse_in = _reflect_pass(
            field, rs_recip, background_color, fcfg, packed)
        outputs["mid_reflect_coarse"] = scatter_reflect(mid_reflect_coarse_in)

    # ---- pass 4: reflected fine ----
    rs_refl_pdf = pdf_sample(reflect_bundle, rs_recip, w_refl_coarse, recip,
                             cfg.num_reflect_importance_samples)
    w_refl_fine, mid_reflect_fine_in = _reflect_pass(
        field, rs_refl_pdf, background_color, fcfg, packed)
    depth_sub = render_depth_median(w_refl_fine, rs_refl_pdf.starts,
                                    rs_refl_pdf.ends)
    depth_reflect_fine = depth_sub
    if sel is not None:
        depth_reflect_fine = torch.zeros((R, 1), dtype=depth_sub.dtype,
                                         device=depth_sub.device)
        depth_reflect_fine[sel] = depth_sub
    outputs["mid_reflect_fine"] = scatter_reflect(mid_reflect_fine_in)
    # valid only where mask (SURVEY B#10)
    outputs["depth_reflect_fine"] = depth_reflect_fine
    return outputs


def final_rgb(outputs):
    """The product image: the reflection-composited fine rgb, or the
    plain fine rgb in primary-only (use_reflection=False) mode."""
    return outputs.get("mid_reflect_fine", outputs["mid_rgb_fine"])
