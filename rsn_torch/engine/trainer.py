"""Chunked full-image render (port of the render half of
rsn.engine.trainer; the train loop is ROADMAP Queue 1 step 7)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from rsn.configs import TrainerConfig
from rsn_torch.core.rays import RayBundle
from rsn_torch.data.cameras import Cameras, generate_image_rays
from rsn_torch.models import model as model_lib
from rsn_torch.models.field import Field

# Adaptive eval compaction: renders start at the remembered bucket and
# re-render at a larger one whenever a chunk drops a masked ray, so the
# image always equals fraction 1.0; the next bucket tracks the worst
# chunk's mask fraction plus REFLECT_HEADROOM.
REFLECT_FRACTION_BUCKETS = (0.25, 0.375, 0.5, 0.625, 0.75, 1.0)
REFLECT_HEADROOM = 0.1


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
                 reflect_memo: Optional[Dict] = None
                 ) -> Dict[str, np.ndarray]:
    """Render camera `camera_index` chunk by chunk on the cameras' device
    -> {name: (H, W, C) numpy}.

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
    packed = model_lib.pack_kernel_operands(field, mcfg)

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
                                        packed=packed)
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
