"""The `mipnerf` method (use_reflection=False: passes 1-2 only, the product
image is mid_rgb_fine) in the port against rsn, on the same numpy inputs
on the CPU: the port-side counterparts of tests/test_mipnerf.py.

fp32 (the plain field); rsn's samplers run with their jitter off, as in
tests/test_torch_train.py, and the port draws the same midpoints
(generator None).  Outputs within 1e-4 (tests/test_torch_model.py's fp32
limit), the analytic normals (a normalized fp32 gradient) within 5e-2:
rsn's own jitted and eager paths put them 2.25e-2 apart on these rays;
losses within 1e-5 of rsn's, the predicted-normal losses 5e-4 (their fp32
floor, test_train_step_fp32_matches_rsn)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsn.cli.registry import get_method as jget_method
from rsn.data.synthetic import make_synthetic_dataset as jdataset
from rsn.engine import trainer as jtrainer
from rsn.models import model as M
import rsn_torch.configs as tcfg
from rsn_torch.cli import render as trender_cli
from rsn_torch.cli.registry import get_method as tget_method
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models import model as tmodel
from torch_parity import (bundles, facing_rays, jax_params, n, port_field,
                          rsn_params, t)

TINY = dict(num_coarse_samples=16, num_importance_samples=16,
            num_reflect_coarse_samples=8, num_reflect_importance_samples=8)
R = 32
REFLECT_KEYS = ("mid_reflect_coarse", "mid_reflect_fine",
                "depth_reflect_fine")
NORMALS_TOL = 5e-2
PRIMARY_KEYS = ("mid_rgb_coarse", "mid_rgb_fine", "accumulation_fine",
                "depth_fine", "roughness", "mask")
COEFFS = ("loss_mid_coarse", "loss_mid_fine", "predicted_normal_loss_coarse",
          "predicted_normal_loss_fine", "orientation_loss_coarse",
          "orientation_loss_fine")


def _cfgs(**kw):
    return tuple(dataclasses.replace(get("mipnerf").config_factory()
                                     .pipeline.model, **TINY, **kw)
                 for get in (jget_method, tget_method))


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    o, d, pa = facing_rays(R)
    return tree, bundles(o, d, pa)


def _midpoints(fn):
    """rsn's get_outputs with its samplers' jitter off (the key dropped)."""
    spaced, pdf = M.spaced_sample, M.pdf_sample
    M.spaced_sample = lambda b, s, k, key=None, **kw: spaced(b, s, k, **kw)
    M.pdf_sample = lambda b, rs, w, s, k, key=None, **kw: pdf(b, rs, w, s,
                                                             k, **kw)
    try:
        return fn()
    finally:
        M.spaced_sample, M.pdf_sample = spaced, pdf


def _outputs(setup, cfg_j, cfg_t):
    tree, (jb, tb) = setup
    jb, tb = M.apply_collider(jb, cfg_j), tmodel.apply_collider(tb, cfg_t)
    out_j = _midpoints(lambda: jax.jit(lambda p: M.get_outputs(
        p, jb, jax.random.PRNGKey(3), cfg_j, training=True))(
            jax_params(tree)))
    out_t = tmodel.get_outputs(port_field(tree), tb, cfg_t, training=True)
    return out_j, out_t


def test_output_keys_exclude_reflection(setup):
    out_j, out_t = _outputs(setup, *_cfgs())
    assert set(out_t) == set(out_j)
    for k in REFLECT_KEYS:
        assert k not in out_t
    for k in PRIMARY_KEYS + ("pred_normals_coarse", "normals_fine",
                             "reflect_overflow"):
        assert k in out_t
    assert tmodel.final_rgb(out_t) is out_t["mid_rgb_fine"]
    mask = np.asarray(out_j["mask"])
    np.testing.assert_array_equal(n(out_t["mask"]), mask)
    for k in out_j:
        tol = NORMALS_TOL if k.startswith("normals") else 1e-4
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k],
                                                           np.float32),
                                   atol=tol, rtol=tol, err_msg=k)


def test_primary_passes_match_full_model(setup):
    """Passes 1-2 do not depend on use_reflection: the same draws give the
    same primary outputs bit for bit in the port, and the port's
    primary-only outputs match rsn's full model's."""
    cfg_j, cfg_off = _cfgs()
    cfg_on = dataclasses.replace(cfg_off, use_reflection=True)
    tree, (jb, tb) = setup
    field = port_field(tree)
    tb = tmodel.apply_collider(tb, cfg_off)
    outs = []
    for cfg in (cfg_off, cfg_on):
        gen = torch.Generator().manual_seed(3)
        outs.append(tmodel.get_outputs(field, tb, cfg, training=True,
                                       generator=gen))
    for k in PRIMARY_KEYS:
        assert torch.equal(outs[0][k], outs[1][k]), k
    out_j, _ = _outputs(setup, dataclasses.replace(cfg_j,
                                                   use_reflection=True),
                        cfg_on)
    _, out_t = _outputs(setup, cfg_j, cfg_off)
    for k in PRIMARY_KEYS:
        np.testing.assert_allclose(n(out_t[k]), np.asarray(out_j[k],
                                                           np.float32),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_loss_dict_and_gradients(setup):
    """The loss dict has no reflect losses, matches rsn's, and the dead
    `low` head gets exactly zero gradient, as in rsn and the reference."""
    cfg_j, cfg_t = _cfgs()
    tree, (jb, tb) = setup
    gt = np.full((R, 3), 0.5, np.float32)
    coeffs = {k: 1.0 for k in COEFFS}

    def rsn_loss(p):
        out = M.get_outputs(p, M.apply_collider(jb, cfg_j),
                            jax.random.PRNGKey(3), cfg_j, training=True)
        return M.get_loss_dict(out, jnp.asarray(gt),
                               {k: jnp.float32(v) for k, v in coeffs.items()})

    ref = _midpoints(lambda: jax.jit(rsn_loss)(jax_params(tree)))
    field = port_field(tree)
    out = tmodel.get_outputs(field, tmodel.apply_collider(tb, cfg_t), cfg_t,
                             training=True)
    loss = tmodel.get_loss_dict(out, t(gt), coeffs)
    assert set(loss) == set(ref) == set(COEFFS)
    for k in COEFFS:
        tol = 5e-4 if k.startswith("predicted") else 1e-5
        assert abs(float(loss[k]) - float(ref[k])) <= tol * max(
            abs(float(ref[k])), 1e-6), k
    total = sum(loss.values())
    total.backward()
    assert torch.isfinite(total)
    grads = {k: p.grad for k, p in field.named_parameters()}
    gnorm = sum(float((g * g).sum()) for g in grads.values()
                if g is not None)
    assert np.isfinite(gnorm) and gnorm > 0
    low = [g for k, g in grads.items() if "field_output_low" in k]
    assert low and all(g is None or float(g.abs().sum()) == 0.0 for g in low)


def test_train_eval_hook_and_render(tmp_path):
    """A few mipnerf train steps on the synthetic scene with the eval-image
    hook, then the chunked render of the trained field against rsn's
    render_image on the same weights, and the eval panels."""
    base = tget_method("mipnerf").config_factory()
    mcfg = dataclasses.replace(base.pipeline.model, **TINY)
    dm = dataclasses.replace(base.pipeline.datamanager, dataparser="synthetic",
                             data="sphere:res=16,cams=2",
                             train_num_rays_per_batch=64,
                             eval_num_rays_per_batch=64)
    config = dataclasses.replace(
        base, pipeline=tcfg.PipelineConfig(model=mcfg, datamanager=dm),
        max_num_iterations=3, steps_per_log=1, steps_per_eval_batch=3,
        steps_per_eval_image=3, steps_per_save=1000, seed=0)
    tr = ttrainer.Trainer(config, run_dir=str(tmp_path / "run"), device="cpu")
    last = tr.train()
    assert np.isfinite(last["total_loss"])
    assert "loss_reflect_mid_fine" not in last
    with open(tmp_path / "run" / "train_log.jsonl") as f:
        assert '"eval_image_coarse_psnr"' in f.read()

    out = ttrainer.render_image(tr.field, tr.eval_cameras, 0, config,
                                rays_per_chunk=64)
    assert out["mid_rgb_fine"].shape == (16, 16, 3)
    assert "mid_reflect_fine" not in out
    panels = trender_cli.render_panels(out, tr.eval_ds.images[0], 2.0, 6.0)
    assert panels["img"].shape == (16, 48, 3)  # gt | coarse | fine

    jcfg = jget_method("mipnerf").config_factory()
    jcfg = dataclasses.replace(jcfg, pipeline=dataclasses.replace(
        jcfg.pipeline, model=dataclasses.replace(jcfg.pipeline.model,
                                                 **TINY)))
    ds = jdataset(num_cameras=2, H=16, W=16, split="test")
    params = jax_params(tckpt.params_to_rsn(
        {k: v.detach() for k, v in tr.field.state_dict().items()}))
    ref = jtrainer.render_image(params, ds.cameras, 0, jcfg,
                                rays_per_chunk=64)
    for k in ("mid_rgb_coarse", "mid_rgb_fine", "accumulation_fine"):
        np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
