"""The port's camera pose refinement (rsn_torch.models.camera_opt and the
trainer's camera path) against rsn's on the CPU, on numpy inputs fed to
both: the Rodrigues rotation and its gradient (at omega = 0 too), the
bundle correction, the regularizer, one training step with the camera on
(fp32, and the bf16 kernel branch on both routes: K3/K4 and K7/K1/K8
against rsn's kernels in interpret mode), the routing of the pose
gradient, a tiny trainer run with its checkpoint and the render CLI, and
(slow) rsn's pose-recovery protocol."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rsn.configs as jcfg
from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn.models import camera_opt as jcam
from rsn.models import field as jfield
from rsn.models import model as M
import rsn_torch.configs as tcfg
from rsn_torch.cli import render as trender_cli
from rsn_torch.cli import run_io as trun_io
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models import camera_opt as tcam
from rsn_torch.models import model as tmodel
from torch_parity import (assert_grads, bundles, facing_rays, jax_params, n,
                          port_field, rsn_params, t)

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps on one thread: beside the suite's other workers, a
    thread pool per core makes each small op wait on the others (as in
    tests/test_torch_trainer_obs.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


R = 16
CAMS = 2
STEP = 100  # past the warmup: the normal losses are on
PENALTIES = (1e-3, 1e-2)
# The pose gradient is a sum of cancelling terms over the rays, through
# bf16 dmc and the contraction's Jacobian.  rsn's own spread on it, in the
# setup below: its jitted and eager fp32 paths differ by 2.5e-3 of its max,
# and its bf16 kernel branch (interpret mode) is 6.1e-2 from its fp32
# gradient.  The limits sit above those spreads (the port reads 4.7e-3 in
# fp32 and 1.2e-2 on either bf16 route).
DELTA_TOL_FP32 = 1e-2
DELTA_TOL_BF16 = 1e-1
# With the rays live, some field leaves are sums of cancelling terms too.
# fp32: twice rsn's own jitted-against-eager spread where it exceeds 1e-4
# (trunk layers 0-5: 5.1e-3, 3.0e-2, 3.2e-3, 2.9e-3, 7.6e-4, 6.8e-3;
# roughness 3.3e-3; the port reads 3.7e-3, 2.0e-2, 9.3e-4, 1.0e-3, 1.1e-3,
# 7.1e-3 and 1.4e-3).  bf16: the roughness head at rsn's own
# bf16-against-fp32 distance on it (1.8e-1; the port reads 9.9e-2 from
# rsn's bf16 gradient).
FIELD_TOLS_FP32 = {("trunk", 0): 1e-2, ("trunk", 1): 6e-2,
                   ("trunk", 2): 7e-3, ("trunk", 3): 6e-3,
                   ("trunk", 4): 2e-3, ("trunk", 5): 1.5e-2,
                   ("roughness", 0): 7e-3}
FIELD_TOLS_BF16 = {("roughness", 0): 2e-1}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("mag", [0.0, 1e-5, 0.3, 2.0])
def test_rotate_rodrigues_matches_rsn(mag):
    """Values and both gradients against rsn's; at |omega| = 0 the
    gradient is finite and equal (the double where)."""
    rng = np.random.default_rng(1)
    axis = rng.normal(size=(6, 3)).astype(np.float32)
    omega = (mag * axis / np.linalg.norm(axis, axis=-1, keepdims=True)
             ).astype(np.float32)
    v = rng.normal(size=(6, 3)).astype(np.float32)
    w = rng.normal(size=(6, 3)).astype(np.float32)
    f = lambda o, x: jnp.sum(jcam.rotate_rodrigues(o, x) * w)
    ref = np.asarray(jcam.rotate_rodrigues(jnp.asarray(omega),
                                           jnp.asarray(v)))
    go_j, gv_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(omega),
                                             jnp.asarray(v))
    ot = t(omega).requires_grad_(True)
    vt = t(v).requires_grad_(True)
    got = tcam.rotate_rodrigues(ot, vt)
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(n(got), ref, rtol=1e-6, atol=1e-6)
    assert np.isfinite(n(ot.grad)).all()
    np.testing.assert_allclose(n(ot.grad), np.asarray(go_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(vt.grad), np.asarray(gv_j), rtol=1e-5,
                               atol=1e-6)
    if mag == 0.0:
        np.testing.assert_array_equal(n(got), v)
        # d(R(w) v)/dw at 0 is the cross product's Jacobian: v x w
        np.testing.assert_allclose(n(ot.grad), np.cross(v, w), atol=1e-6)


def _bundle_pair(o, d, pa, ci):
    jb, tb = bundles(o, d, pa)
    return (jb.replace(camera_indices=jnp.asarray(ci, jnp.int32)),
            dataclasses.replace(tb, camera_indices=torch.from_numpy(ci)))


@pytest.mark.parametrize("mode", ["off", "SO3xR3"])
def test_apply_to_bundle_matches_rsn(mode):
    o, d, pa = facing_rays(R)
    ci = (np.arange(R) % CAMS)[:, None]
    jb, tb = _bundle_pair(o, d, pa, ci)
    rng = np.random.default_rng(2)
    deltas = (0.05 * rng.normal(size=(CAMS, 6))).astype(np.float32)
    wo, wd = (rng.normal(size=(R, 3)).astype(np.float32) for _ in range(2))
    if mode == "off":
        assert tcam.init_camera_opt_params(CAMS, mode) is None
        assert tcam.apply_to_bundle(tb, None, mode) is tb
        assert tcam.apply_to_bundle(tb, t(deltas), mode) is tb
        return

    def proj(b):
        return jnp.sum(b.origins * wo) + jnp.sum(b.directions * wd)

    ref = jcam.apply_to_bundle(jb, {"deltas": jnp.asarray(deltas)}, mode)
    g_j = jax.grad(lambda c: proj(jcam.apply_to_bundle(jb, c, mode)))(
        {"deltas": jnp.asarray(deltas)})["deltas"]
    dt = t(deltas).requires_grad_(True)
    got = tcam.apply_to_bundle(tb, dt, mode)
    ((got.origins * t(wo)).sum() + (got.directions * t(wd)).sum()).backward()
    np.testing.assert_allclose(n(got.origins), np.asarray(ref.origins),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(got.directions), np.asarray(ref.directions),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(n(dt.grad), np.asarray(g_j), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="camera_indices"):
        tcam.apply_to_bundle(dataclasses.replace(tb, camera_indices=None),
                             dt, mode)


def test_init_and_regularizer_match_rsn():
    p = tcam.init_camera_opt_params(3, "SO3xR3")
    assert isinstance(p, torch.nn.Parameter) and p.shape == (3, 6)
    assert float(p.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="unknown"):
        tcam.init_camera_opt_params(3, "SE3")
    deltas = (0.1 * np.random.default_rng(4).normal(size=(3, 6))
              ).astype(np.float32)
    ref, g_j = jax.value_and_grad(lambda c: jcam.regularization_loss(
        c, *PENALTIES))({"deltas": jnp.asarray(deltas)})
    dt = t(deltas).requires_grad_(True)
    got = tcam.regularization_loss(dt, *PENALTIES)
    got.backward()
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(n(dt.grad), np.asarray(g_j["deltas"]),
                               rtol=1e-6)
    assert float(tcam.regularization_loss(None)) == 0.0


# ---- one training step with the camera on -------------------------------

_MCFG = dict(num_coarse_samples=8, num_importance_samples=8,
             num_reflect_coarse_samples=8, num_reflect_importance_samples=8)
_RSN_KERNELS = ((jft, "field_forward_v6"), (jft, "field_backward_v5"),
                (jft, "field_backward_v6"), (jft, "field_forward_v3"),
                (fp, "field_forward_v4"), (jft, "field_backward_v4"))


@pytest.fixture(scope="module")
def scene():
    tree = rsn_params(4, crafted_normals=True)
    o, d, pa = facing_rays(R)
    gt = np.random.default_rng(5).uniform(0, 1, (R, 3)).astype(np.float32)
    ci = (np.arange(R) % CAMS)[:, None]
    deltas = (0.01 * np.random.default_rng(6).normal(size=(CAMS, 6))
              ).astype(np.float32)
    return tree, (o, d, pa, ci), gt, deltas


def _rsn_camera_step(tree, rays, gt, deltas, cfg, save_acts=None):
    """rsn's camera-on step (rsn/engine/trainer.py's two VJPs: every loss
    for the field, the photometric losses and the regularizer for the
    camera) with the samplers' jitter off; save_acts: rsn's train kernels
    in interpret mode on that route (None: its XLA path)."""
    jb, _ = _bundle_pair(*rays)
    jb = M.apply_collider(jb, cfg)
    spaced, pdf, field_cfg = M.spaced_sample, M.pdf_sample, M._field_cfg
    saved = {(m, k): getattr(m, k) for m, k in _RSN_KERNELS}
    M.spaced_sample = lambda b, s, k, key=None, **kw: spaced(b, s, k, **kw)
    M.pdf_sample = lambda b, rs, w, s, k, key=None, **kw: pdf(b, rs, w, s,
                                                             k, **kw)
    if save_acts is not None:
        M._field_cfg = lambda c: jfield.FieldConfig(
            compute_dtype=jnp.bfloat16, sh_l8_m7_2x=True, use_pallas=True,
            use_pallas_train=True, save_acts=save_acts,
            pallas_interpret=True)
        for (m, k), fn in saved.items():
            setattr(m, k, functools.partial(fn, interpret=True))
    coeffs = jcfg.loss_coefficients_at_step(STEP)

    def forward(p, cam):
        b = jcam.apply_to_bundle(jb, cam, "SO3xR3")
        out = M.get_outputs(p, b, jax.random.PRNGKey(0), cfg, training=True,
                            rays_live=True)
        ld = dict(M.get_loss_dict(out, jnp.asarray(gt), coeffs),
                  camera_opt_regularizer=jcam.regularization_loss(
                      cam, *PENALTIES))
        return ld, out["mask"]

    def step(p, cam):
        ld, vjp, mask = jax.vjp(forward, p, cam, has_aux=True)
        grads, _ = vjp({k: jnp.float32(1.0) for k in ld})
        photo = {k: jnp.float32(1.0 if k in M.PHOTOMETRIC_LOSS_KEYS
                                or k == "camera_opt_regularizer" else 0.0)
                 for k in ld}
        _, cam_grads = vjp(photo)
        return ld, grads, cam_grads["deltas"], mask

    try:
        ld, grads, cam_g, mask = jax.jit(step)(
            jax_params(tree), {"deltas": jnp.asarray(deltas)})
    finally:
        M.spaced_sample, M.pdf_sample, M._field_cfg = spaced, pdf, field_cfg
        for (m, k), fn in saved.items():
            setattr(m, k, fn)
    return ({k: float(v) for k, v in ld.items()},
            jax.tree.map(np.asarray, grads), np.asarray(cam_g),
            np.asarray(mask))


def _port_camera_step(tree, rays, gt, deltas, cfg):
    """The port's camera-on step: the trainer's routed backward."""
    _, tb = _bundle_pair(*rays)
    tb = tmodel.apply_collider(tb, cfg)
    field = port_field(tree)
    cam = torch.nn.Parameter(t(deltas))
    out = tmodel.get_outputs(field, tcam.apply_to_bundle(tb, cam, "SO3xR3"),
                             cfg, training=True, rays_live=True)
    ld = tmodel.get_loss_dict(out, t(gt),
                              tcfg.loss_coefficients_at_step(STEP))
    ld[ttrainer.CAMERA_REG_KEY] = tcam.regularization_loss(cam, *PENALTIES)
    ttrainer.routed_backward(ld, field.parameters(), cam)
    grads = tckpt.params_to_rsn({k: (p.grad if p.grad is not None
                                     else torch.zeros_like(p))
                                 for k, p in field.named_parameters()})
    return ({k: float(v.detach()) for k, v in ld.items()}, grads,
            n(cam.grad), n(out["mask"]))


@pytest.mark.parametrize("route", ["fp32", "bf16-spill", "bf16-recompute"])
def test_camera_train_step_matches_rsn(scene, route):
    """Losses, field gradients and the pose-delta gradients of one step
    with the camera on, against rsn's.  bf16: the port's plain K3/K4
    (spill) or K7/K1/K8 (recompute) under the autograd Function against
    rsn's kernels in interpret mode on the same route."""
    tree, rays, gt, deltas = scene
    kw = dict(_MCFG)
    save_acts = None
    if route != "fp32":
        save_acts = route == "bf16-spill"
        kw.update(compute_dtype="bfloat16", reflect_ray_fraction=0.5)
    lj, gj, cj, mj = _rsn_camera_step(tree, rays, gt, deltas,
                                      jcfg.ModelConfig(**kw), save_acts)
    cfg_t = tcfg.ModelConfig(use_pallas_acts=bool(save_acts), **kw)
    if save_acts is not None:
        assert tmodel._field_cfg(cfg_t).save_acts == save_acts
    lt, gt_, ct, mt = _port_camera_step(tree, rays, gt, deltas, cfg_t)
    assert 0 < mj.mean() < 1
    np.testing.assert_array_equal(mt, mj)
    assert set(lt) == set(lj)
    assert np.abs(cj).max() > 0
    if route == "fp32":
        # the normal losses compare normalized fp32 gradients: rsn's own
        # jitted and eager paths differ by up to 3.3e-4 on them here
        normal_losses = ("predicted_normal_loss_coarse",
                         "predicted_normal_loss_fine")
        for k in lj:
            tol = 1e-3 if k in normal_losses else 1e-5
            assert abs(lt[k] - lj[k]) <= tol * max(abs(lj[k]), 1e-6), k
        assert_grads(gt_, gj, 1e-4, FIELD_TOLS_FP32)
        assert _rel(ct, cj) <= DELTA_TOL_FP32
    else:
        for k in lj:
            assert abs(lt[k] - lj[k]) <= 2e-2 * max(abs(lj[k]), 1e-6), k
        assert_grads(gt_, gj, 5e-2, FIELD_TOLS_BF16)
        assert _rel(ct, cj) <= DELTA_TOL_BF16


def test_pose_gradient_is_photometric_only(scene):
    """The routed backward: the deltas get the gradient of the
    photometric losses + the regularizer alone (recomputed on a fresh
    graph), the field the gradient of every loss, and the non-photometric
    losses do move the poses (so the routing matters: the normals head is
    not the scene's crafted constant here).  An unclassified loss key
    raises."""
    _, rays, gt, deltas = scene
    tree = rsn_params(4)
    cfg = tcfg.ModelConfig(**_MCFG)
    _, tb = _bundle_pair(*rays)
    tb = tmodel.apply_collider(tb, cfg)
    coeffs = tcfg.loss_coefficients_at_step(STEP)

    def losses(field, cam):
        out = tmodel.get_outputs(field, tcam.apply_to_bundle(tb, cam,
                                                             "SO3xR3"),
                                 cfg, training=True, rays_live=True)
        ld = tmodel.get_loss_dict(out, t(gt), coeffs)
        ld[ttrainer.CAMERA_REG_KEY] = tcam.regularization_loss(cam,
                                                               *PENALTIES)
        return ld

    field, cam = port_field(tree), torch.nn.Parameter(t(deltas))
    ttrainer.routed_backward(losses(field, cam), field.parameters(), cam)
    routed = {k: p.grad for k, p in field.named_parameters()}

    ld = losses(field, cam)
    photo = sum(v for k, v in ld.items()
                if k in tmodel.PHOTOMETRIC_LOSS_KEYS
                or k == ttrainer.CAMERA_REG_KEY)
    (want,) = torch.autograd.grad(photo, [cam], retain_graph=True)
    (every,) = torch.autograd.grad(sum(ld.values()), [cam],
                                   retain_graph=True)
    names = [k for k, _ in field.named_parameters()]
    field_ref = torch.autograd.grad(sum(ld.values()),
                                    list(field.parameters()),
                                    allow_unused=True)
    torch.testing.assert_close(cam.grad, want, rtol=1e-6, atol=0)
    assert float((every - want).abs().max()) > 1e-3 * float(want.abs().max())
    for k, g in zip(names, field_ref):
        assert (routed[k] is None) == (g is None), k
        if g is not None:
            torch.testing.assert_close(routed[k], g, rtol=1e-6, atol=0)

    with pytest.raises(ValueError, match="new_loss"):
        ttrainer.camera_objective({"loss_mid_fine": photo,
                                   "new_loss": photo})


# ---- the trainer, its checkpoint and the render CLI ----------------------

def test_trainer_runs_the_camera_on_the_recompute_route(tmp_path):
    """A tiny bf16 run with camera_optimizer SO3xR3 and use_pallas_acts
    off: the deltas move and stay finite, the checkpoint holds them with
    their Adam state and schedule, restore reads all back (the next step
    agrees bit for bit), and the render CLI loads the run."""
    mcfg = tcfg.ModelConfig(compute_dtype="bfloat16", use_pallas_acts=False,
                            **_MCFG)
    dm = tcfg.DataManagerConfig(dataparser="synthetic",
                                data="sphere:res=8,cams=2",
                                train_num_rays_per_batch=16,
                                camera_optimizer="SO3xR3")
    config = tcfg.TrainerConfig(output_dir=str(tmp_path), steps_per_log=5,
                                steps_per_save=5, max_num_iterations=10,
                                seed=3, pipeline=tcfg.PipelineConfig(
                                    model=mcfg, datamanager=dm))
    run = str(tmp_path / "a")
    tr = ttrainer.Trainer(config, run_dir=run, device="cpu")
    assert tuple(tr.camera.shape) == (2, 6)
    tr.train()
    deltas = n(tr.camera).copy()
    assert np.isfinite(deltas).all() and np.abs(deltas).max() > 0
    state = tckpt.load_checkpoint(os.path.join(run, "checkpoints",
                                               "step-000000010.pt"))
    np.testing.assert_array_equal(state["camera"].numpy(), deltas)
    assert set(state["camera_optimizer"]["state"][0]) >= {"exp_avg",
                                                          "exp_avg_sq"}
    assert state["camera_scheduler"]["last_epoch"] == 10

    tr2 = ttrainer.Trainer(config, run_dir=str(tmp_path / "b"), device="cpu")
    tr2.restore(os.path.join(run, "checkpoints"))
    assert torch.equal(tr2.camera, tr.camera)
    for k, v in tr.cam_optimizer.state_dict()["state"][0].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(
            tr2.cam_optimizer.state_dict()["state"][0][k])), k
    assert tr2.cam_scheduler.last_epoch == 10
    tr.train_step()
    tr2.train_step()
    assert torch.equal(tr.camera, tr2.camera)

    _, _, _, extras = trun_io.load_run_full(run)
    np.testing.assert_array_equal(n(extras["camera"]), deltas)
    frames = str(tmp_path / "frames")
    assert trender_cli.main(["--load-dir", run, "--mode", "orbit",
                             "--num-frames", "1", "--output-dir", frames],
                            device="cpu") == 0
    assert os.listdir(frames) == ["frame_00000.png"]


@pytest.mark.slow
def test_pose_only_recovery_reduces_ray_error():
    """rsn's pose-recovery protocol (tests/test_camera_opt_recovery.py) on
    the port, fp32 on the CPU: after < 0.75 x before, |t| < 0.3."""
    import chip_smoke

    before, after, trans = chip_smoke.pose_recovery(
        torch.device("cpu"), "float32", True)
    assert before > 0.8, before
    assert after < 0.75 * before, (before, after)
    assert trans < 0.3, trans
