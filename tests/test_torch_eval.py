"""The port's eval hooks and log lines against rsn's, on the same numpy
inputs on the CPU: PSNR and SSIM (within 1e-4 dB and 1e-5), the turbo
colormap and the eval panels (bit for bit; matplotlib, rsn's colormap
source, is needed here and the test skips without it), the eval-batch
step on one pixel batch (the fp32 step parity limits of
tests/test_torch_train.py), and the train loop's log lines (keys with
debug_telemetry off and on, rays_per_sec from the run's start, the reflect
bucket after the step's controller decision) from the same per-step
metrics and the same clock."""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rsn.configs as jcfg
from rsn import metrics as jmetrics
from rsn.cli.registry import get_method as jget_method
from rsn.engine import trainer as jtrainer
from rsn.models import proposal as jprop
import rsn_torch.configs as tcfg
from rsn_torch import metrics as tmetrics
from rsn_torch.cli import render as trender_cli
from rsn_torch.cli.registry import get_method as tget_method
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models import proposal as tprop
from rsn_torch.utils._turbo_table import TURBO
from torch_parity import (bundles, facing_rays, jax_params, port_field,
                          rsn_params, t)


def _images(case: str):
    """tests/test_metrics.py's image pairs, and a half-flat one."""
    if case == "identical":
        a = np.random.default_rng(0).uniform(0, 1, (32, 32, 3))
        return a.astype(np.float32), a.astype(np.float32)
    if case == "flat":  # test_ssim_bounded_on_flat_regions
        rng = np.random.default_rng(3)
        a = np.full((64, 64, 3), 0.73, np.float32)
        b = a.copy()
        b[30:34, 30:34] += rng.normal(0, 0.05, (4, 4, 3)).astype(np.float32)
        return a, np.clip(b, 0, 1)
    if case == "half_flat":
        rng = np.random.default_rng(4)
        a = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
        a[:, :24] = 0.73
        return a, np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(
            np.float32)
    size, seed, sigma = {"noisy": (48, 1, 0.1), "slight": (32, 2, 0.02),
                         "heavy": (32, 2, 0.3)}[case]
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, sigma, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("case", ["identical", "noisy", "slight", "heavy",
                                  "flat", "half_flat"])
def test_psnr_and_ssim_match_rsn(case):
    """PSNR within 1e-4 dB and SSIM within 1e-5 of rsn's on
    tests/test_metrics.py's pairs; on the half-flat pair (zero-variance
    windows beside textured ones) rsn's fp32 SSIM is 1.1e-5 from the
    float64 value, so there the port is held to float64 within 1e-5."""
    a, b = _images(case)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert abs(float(tmetrics.psnr(t(a), t(b)))
               - float(jmetrics.psnr(ja, jb))) <= 1e-4
    got = float(tmetrics.ssim(t(a), t(b)))
    ref = (float(tmetrics.ssim(torch.from_numpy(a).double(),
                               torch.from_numpy(b).double()))
           if case == "half_flat" else float(jmetrics.ssim(ja, jb)))
    assert abs(got - ref) <= 1e-5 and got <= 1.0 + 1e-6


def test_turbo_colormap_is_matplotlibs():
    mpl = pytest.importorskip("matplotlib")
    from rsn.cli import render as jrender_cli

    lut = mpl.colormaps["turbo"](np.arange(256))[:, :3]
    np.testing.assert_array_equal(np.asarray(TURBO), lut)
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.uniform(-0.1, 1.1, 100_000),
                        [0.0, 1.0, 0.5, 255 / 256, 1 - 2 ** -24]])
    v = v.astype(np.float32).reshape(-1, 1, 1)
    np.testing.assert_array_equal(trender_cli.apply_colormap(v),
                                  jrender_cli.apply_colormap(v))


def test_render_panels_match_rsn():
    pytest.importorskip("matplotlib")
    from rsn.cli import render as jrender_cli

    rng = np.random.default_rng(7)
    H, W = 6, 5
    out = {k: rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
           for k in ("mid_rgb_coarse", "mid_rgb_fine", "mid_reflect_fine")}
    for k in ("accumulation_coarse", "accumulation_fine"):
        out[k] = rng.uniform(0, 1, (H, W, 1)).astype(np.float32)
    for k in ("depth_coarse", "depth_fine"):
        out[k] = rng.uniform(1.5, 6.5, (H, W, 1)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    got = trender_cli.render_panels(out, gt, 2.0, 6.0)
    ref = jrender_cli.render_panels(out, gt, 2.0, 6.0)
    assert set(got) == set(ref) == {"img", "accumulation", "depth"}
    assert got["img"].shape == (H, 3 * W, 3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


_TINY = dict(num_coarse_samples=8, num_importance_samples=8,
             num_reflect_coarse_samples=8, num_reflect_importance_samples=8,
             num_proposal_samples=8)


def _configs(method: str, **trainer):
    """The registry's `method` in both packages at the tiny widths."""
    out = []
    for get, cfg_lib in ((jget_method, jcfg), (tget_method, tcfg)):
        base = get(method).config_factory()
        model = dataclasses.replace(base.pipeline.model, **_TINY)
        dm = dataclasses.replace(base.pipeline.datamanager,
                                 dataparser="synthetic",
                                 data="sphere:res=8,cams=2",
                                 train_num_rays_per_batch=16,
                                 eval_num_rays_per_batch=16)
        out.append(dataclasses.replace(
            base, pipeline=cfg_lib.PipelineConfig(model=model, datamanager=dm),
            **trainer))
    return out


_RSN_EVAL_STEPS = {}


def _rsn_eval_step(method, cfg):
    """rsn's eval-batch step, jitted once per method (the step traced)."""
    if method not in _RSN_EVAL_STEPS:
        step_fn = jtrainer.make_eval_batch_step(cfg)
        _RSN_EVAL_STEPS[method] = jax.jit(lambda p, q, step: step_fn(
            types.SimpleNamespace(params=p, proposal=q, step=step), None,
            None, jax.random.PRNGKey(0)))
    return _RSN_EVAL_STEPS[method]


@pytest.mark.parametrize("step", [10, 60])
@pytest.mark.parametrize("method", ["reflect-sampling-nerf",
                                    "reflect-sampling-nerf-proposal"])
def test_eval_batch_matches_rsn(monkeypatch, method, step):
    """rsn's make_eval_batch_step and the port's eval_batch_metrics on one
    drawn batch (rsn's sampler patched to return it): the eval-mode loss
    sum with `step`'s coefficients (the warmup's zeros at step 10, the
    normal losses on at 60, the proposal's interlevel and distortion
    terms) and the batch PSNR."""
    cfg_j, cfg_t = _configs(method)
    tree = rsn_params(4, crafted_normals=True)
    o, d, pa = facing_rays(16)
    gt = np.random.default_rng(5).uniform(0, 1, (16, 3)).astype(np.float32)
    jb, tb = bundles(o, d, pa)
    use_prop = cfg_t.pipeline.model.use_proposal
    ptree = (jax.tree.map(np.asarray, jprop.init_proposal_params(
        jax.random.PRNGKey(0))) if use_prop else None)
    monkeypatch.setattr(jtrainer, "sample_pixel_batch",
                        lambda *a: (jb, jnp.asarray(gt)))
    ref = _rsn_eval_step(method, cfg_j)(jax_params(tree),
                                None if ptree is None else jax_params(ptree),
                                jnp.int32(step))
    proposal = None
    if use_prop:
        proposal = tprop.ProposalField()
        proposal.load_state_dict(tckpt.proposal_from_rsn(ptree))
    got = ttrainer.eval_batch_metrics(port_field(tree), tb, t(gt), cfg_t,
                                      step, proposal)
    assert set(got) == {"eval_loss", "eval_psnr_batch"}
    # the normal losses' fp32 floor (test_train_step_fp32_matches_rsn)
    tol = 1e-5 if step < 50 else 5e-4
    for k in got:
        assert abs(got[k] - float(ref[k])) <= tol * abs(float(ref[k])), k


_LOSSES = ("loss_mid_coarse", "loss_mid_fine", "loss_reflect_mid_coarse",
           "loss_reflect_mid_fine", "predicted_normal_loss_coarse",
           "predicted_normal_loss_fine", "orientation_loss_coarse",
           "orientation_loss_fine")


def _metrics(step: int):
    """One step's losses and telemetry, the same for both loops."""
    m = {k: 0.1 * (i + 1) + 0.01 * step for i, k in enumerate(_LOSSES)}
    m["total_loss"] = sum(m.values())
    m.update(mask_fraction=0.3, reflect_overflow=0.0)
    return m


class _Clock:
    """A host clock where the step k takes k seconds."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_log_lines_match_rsn(tmp_path, monkeypatch):
    """Both loops on the same per-step metrics and clock, the controller
    patched to move the bucket to 0.75 at every adapt step: two steps with
    debug_telemetry off, then one with it on."""
    cfg_j, cfg_t = _configs("reflect-sampling-nerf", steps_per_log=1,
                            steps_per_save=1000, seed=3, num_devices=1)
    num_rays = 16

    jclock = _Clock()
    monkeypatch.setattr(jtrainer, "time", types.SimpleNamespace(time=jclock))
    jt = jtrainer.Trainer(cfg_j, run_dir=str(tmp_path / "j"))

    def jstep(state, images, cameras, key, chunk):
        step = int(state.step) + int(chunk)
        jclock.now += step
        return state.replace(step=state.step + chunk), _metrics(step)

    jt._build_multi_step = lambda frac: jstep
    jt._multi_step_fn = jstep
    jt._maybe_adapt_reflect_fraction = lambda m: jt._set_reflect_fraction(
        0.75)

    tclock = _Clock()
    monkeypatch.setattr(ttrainer, "time",
                        types.SimpleNamespace(perf_counter=tclock))
    tt = ttrainer.Trainer(cfg_t, run_dir=str(tmp_path / "t"), device="cpu")

    def tstep():
        tt.step += 1
        tclock.now += tt.step
        return {k: torch.tensor(v) for k, v in _metrics(tt.step).items()}

    tt.train_step = tstep
    tt._maybe_adapt_reflect_fraction = lambda m: tt._set_reflect_fraction(
        0.75)

    for tr in (jt, tt):
        tr.train(2)
        tr.config = dataclasses.replace(tr.config, debug_telemetry=True)
        tr.train(3)
    ref = _lines(tmp_path / "j" / "train_log.jsonl")
    got = _lines(tmp_path / "t" / "train_log.jsonl")
    assert [e["step"] for e in got] == [e["step"] for e in ref] == [1, 2, 3]
    for g, r in zip(got, ref):
        assert list(g) == list(r)  # the same keys in the same order
        assert g["reflect_fraction"] == r["reflect_fraction"] == 0.75
    base = {"step", "rays_per_sec", "total_loss", "reflect_fraction",
            *_LOSSES}
    assert set(got[0]) == set(got[1]) == base
    assert set(got[2]) == base | {"mask_fraction", "reflect_overflow"}
    # from the start of each train() call: steps 1-2 took 1 + 2 s, the
    # second call's step 3 took 3 s
    want = [num_rays / 1.0, 2 * num_rays / 3.0, num_rays / 3.0]
    for g, r, w in zip(got, ref, want):
        assert g["rays_per_sec"] == pytest.approx(w, rel=1e-12)
        assert r["rays_per_sec"] == pytest.approx(w, rel=1e-12)


def test_trainer_eval_split_and_hooks(tmp_path, capsys):
    """A tiny CPU run with both hooks: the eval split is the synthetic
    scene's "test" cameras (falling back to "train" on FileNotFoundError),
    eval lines at rsn's cadence, the panels of every eval image."""
    cfg = _configs("reflect-sampling-nerf", steps_per_log=2,
                   steps_per_eval_batch=2, steps_per_eval_image=4,
                   max_num_iterations=4, steps_per_save=1000)[1]
    # 16x16 images: the SSIM window is 11 wide
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, model=dataclasses.replace(cfg.pipeline.model,
                                                compute_dtype="bfloat16"),
        datamanager=dataclasses.replace(cfg.pipeline.datamanager,
                                        data="sphere:res=16,cams=2")))
    tr = ttrainer.Trainer(cfg, run_dir=str(tmp_path / "a"), device="cpu")
    assert tr.eval_ds.split == "test"
    tr.train()
    log = _lines(tmp_path / "a" / "train_log.jsonl")
    evals = [(e["step"], sorted(k for k in e if k != "step")) for e in log
             if "total_loss" not in e]
    image_keys = sorted(f"eval_image_{k}" for k in (
        "fine_psnr", "fine_ssim", "coarse_psnr", "psnr"))
    assert evals == [(2, ["eval_loss", "eval_psnr_batch"]),
                     (4, ["eval_loss", "eval_psnr_batch"]),
                     (4, image_keys)]
    m = log[-1]
    assert m["eval_image_psnr"] == m["eval_image_fine_psnr"]
    assert 0.0 <= m["eval_image_fine_ssim"] <= 1.0
    assert "step 4: eval image psnr=" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "a" / "eval_images")) == [
        "000000004-accumulation.png", "000000004-depth.png",
        "000000004-img.png"]

    def missing(parser, data, split, *a):
        if split != "train":
            raise FileNotFoundError(split)
        return real(parser, data, split, *a)

    real = ttrainer.load_dataset
    ttrainer.load_dataset = missing
    try:
        tr2 = ttrainer.Trainer(cfg, run_dir=str(tmp_path / "b"),
                               device="cpu")
    finally:
        ttrainer.load_dataset = real
    assert tr2.eval_ds is tr2.train_ds
