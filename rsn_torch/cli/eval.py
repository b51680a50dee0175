"""rsn_torch eval — the port of rsn-eval (the `ns-eval` equivalent):
metrics of a run over a split, as JSON.

    python -m rsn_torch.cli.eval --load-dir RUN [--split test] \
        [--max-images N] [--output-path FILE]

Loads the run dir (config.json and its latest checkpoint), renders each
image of the split (the test split by default) in chunks and writes
{psnr, coarse_psnr, fine_psnr, fine_ssim[, fine_lpips]}, each the mean
over the images, to --output-path (default RUN/eval.json) and as the last
line of its output.  The keys are the reference's
(reflect_sampling_nerf_model.py:474-480) with rsn's fixes: the coarse
PSNR from mid_rgb_coarse, null in proposal mode (no coarse rgb head);
`psnr` is the fine PSNR of final_rgb.  fine_lpips only where LPIPS
weights are on disk (rsn_torch.metrics.load_lpips).  Runs on the CUDA
card, and raises when torch sees none; a Python caller may ask for the
CPU with main(argv, device="cpu").  A run whose num_devices is above 1 (or
0, with several cards) renders over the mesh, as rsn's eval does: one
spawned rank per device (rsn_torch.parallel.mesh.launch), each image
sharded over the ranks, rank 0 writing eval.json and the lines.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from rsn_torch import metrics as metrics_lib
from rsn_torch.data.synthetic import Dataset


def evaluate(field, dataset: Dataset, config, device="cpu",
             max_images: Optional[int] = None, proposal=None,
             lpips_net=None,
             log: Optional[Callable[[str], None]] = None, mesh=None
             ) -> Dict[str, Optional[float]]:
    """Mean metrics over the split's first max_images images (all by
    default), rendered on `device`.  lpips_net: the LPIPS to score with
    (None: no fine_lpips).  log: called with one line per image (its
    render and metric seconds, LPIPS ms).  mesh: every rank calls this,
    each image renders sharded over the ranks, and each rank scores the
    whole image."""
    from rsn_torch.engine.trainer import preferred_eval_chunk, render_image
    from rsn_torch.models.model import final_rgb

    cams = dataset.cameras.to(device)
    n = cams.num_cameras if max_images is None else min(max_images,
                                                        cams.num_cameras)
    # no coarse rgb head in proposal mode: the key stays, as null, so
    # eval.json is key-compatible across methods
    report_coarse = not config.pipeline.model.use_proposal
    chunk = preferred_eval_chunk(config, device)
    memo: Dict = {}
    per_image = []
    for i in range(n):
        t0 = time.perf_counter()
        out = render_image(field, cams, i, config, rays_per_chunk=chunk,
                           mesh=mesh, reflect_memo=memo, proposal=proposal)
        gt = dataset.images[i]
        fine = np.clip(final_rgb(out), 0, 1)
        gt_t = torch.as_tensor(gt, device=device)
        fine_t = torch.as_tensor(fine, device=device)
        m = {"fine_psnr": float(metrics_lib.psnr(fine_t, gt_t)),
             "fine_ssim": float(metrics_lib.ssim(fine_t, gt_t))}
        if report_coarse:
            coarse = np.clip(out["mid_rgb_coarse"], 0, 1)
            m["coarse_psnr"] = float(metrics_lib.psnr(
                torch.as_tensor(coarse, device=device), gt_t))
        else:
            m["coarse_psnr"] = None
        t1 = time.perf_counter()
        lp = (metrics_lib.lpips(fine, gt, lpips_net)
              if lpips_net is not None else None)
        t2 = time.perf_counter()
        if lp is not None:
            m["fine_lpips"] = lp
        m["psnr"] = m["fine_psnr"]
        per_image.append(m)
        if log is not None:
            log(f"image {i + 1}/{n}: {t2 - t0:.4f} s (render and PSNR / "
                f"SSIM {t1 - t0:.4f} s, LPIPS {1e3 * (t2 - t1):.4f} ms), "
                + json.dumps(m))
    return {k: (float(np.mean([m[k] for m in per_image]))
                if per_image[0][k] is not None else None)
            for k in per_image[0]}


def main(argv=None, device=None) -> int:
    """The CLI; device: the caller's choice of device (default the card)."""
    import argparse

    from rsn_torch.cli.run_io import entry_device, load_config
    from rsn_torch.parallel import mesh as mesh_lib

    p = argparse.ArgumentParser(description="evaluate a trained run "
                                            "(PyTorch port)")
    p.add_argument("--load-dir", required=True,
                   help="run dir (contains config.json + checkpoints/)")
    p.add_argument("--output-path", default=None)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--split", default=None,
                   help="override eval split (val/test)")
    ns = p.parse_args(argv)
    device = str(entry_device(device))
    k = mesh_lib.local_ranks_for(load_config(ns.load_dir).num_devices, 1,
                                 device)
    if k > 1:
        mesh_lib.launch(eval_rank, k, (ns,), device=device)
    else:
        eval_rank(None, ns, device)
    return 0


def eval_rank(mesh, ns, device=None) -> None:
    """The eval of one rank of `mesh` (of the whole run without one);
    rank 0 writes eval.json and prints the lines."""
    from rsn_torch.cli.run_io import load_run_full
    from rsn_torch.data.blender import load_dataset

    device = mesh.device if mesh is not None else torch.device(device)
    primary = mesh is None or mesh.is_primary
    field, config, _, extras = load_run_full(ns.load_dir, device)
    dm = config.pipeline.datamanager
    # ns-eval convention: the test split for every parser
    dataset = load_dataset(dm.dataparser, dm.data or "", ns.split or "test",
                           dm.downscale_factor, dm.scale_factor)
    results = evaluate(field, dataset, config, device,
                       max_images=ns.max_images,
                       proposal=extras.get("proposal"),
                       lpips_net=metrics_lib.load_lpips(device),
                       log=(lambda line: print(line, flush=True))
                       if primary else None, mesh=mesh)
    if not primary:
        return
    out_path = ns.output_path or os.path.join(ns.load_dir, "eval.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    sys.exit(main())
