"""rsn_torch's training path against rsn's on the CPU: the pieces the
train step adds (safe_sqrt's clamped backward, the bf16 matmul's
backward, the analytic normals, stratified PDF draws), the whole train
step in fp32 (plain field) and in bf16 (the fused kernels' plain versions
against rsn's Pallas kernels in interpret mode), RAdam + the decay
schedule against optax, the synthetic ground truth, config.json between
the packages, and the trainer and train CLI at a tiny size."""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rsn.configs as jcfg
from rsn.cli.run_io import load_config as rsn_load_config
from rsn.core import render as jrender
from rsn.data.synthetic import make_synthetic_dataset as rsn_dataset
from rsn.engine import checkpoints as jckpt
from rsn.engine import optimizers as joptim
from rsn.kernels import field_train as jft
from rsn.models import field as jfield
from rsn.models import model as M
import rsn_torch.configs as tcfg
from rsn_torch.cli import render as trender_cli
from rsn_torch.cli import run_io as trun_io
from rsn_torch.cli import train as ttrain_cli
from rsn_torch.core import render as trender
from rsn_torch.core.sampling import pdf_sample
from rsn_torch.core.spacing import identity_spacing, spaced_sample
from rsn_torch.data.synthetic import make_synthetic_dataset
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import optimizers as toptim
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.models import field as tfield
from rsn_torch.models import model as tmodel
from torch_parity import (assert_grads as _assert_grads, bundles,
                          facing_rays, jax_params, n, port_field,
                          rsn_params, t)

R = 16


def _rays():
    # half the rays look at the scene from z=+4, half point away
    return facing_rays(R)


def _mcfg(**kw):
    return dict(num_coarse_samples=8, num_importance_samples=8,
                num_reflect_coarse_samples=8,
                num_reflect_importance_samples=8, **kw)


def _rsn_step(params, jb, gt, cfg, step=100):
    """rsn's loss dict and grads with the samplers' jitter off."""
    spaced, pdf = M.spaced_sample, M.pdf_sample
    M.spaced_sample = lambda b, s, k, key=None, **kw: spaced(b, s, k, **kw)
    M.pdf_sample = lambda b, rs, w, s, k, key=None, **kw: pdf(b, rs, w, s,
                                                             k, **kw)
    try:
        def total(p):
            out = M.get_outputs(p, jb, jax.random.PRNGKey(0), cfg,
                                training=True, rays_live=False)
            ld = M.get_loss_dict(out, gt,
                                 jcfg.loss_coefficients_at_step(step))
            return sum(jax.tree.leaves(ld)), (ld, out["mask"])

        (_, (ld, mask)), grads = jax.jit(jax.value_and_grad(
            total, has_aux=True))(params)
    finally:
        M.spaced_sample, M.pdf_sample = spaced, pdf
    return ({k: float(v) for k, v in ld.items()}, np.asarray(mask),
            jax.tree.map(np.asarray, grads))


def _port_step(field, tb, gt, cfg, step=100):
    field.zero_grad()
    out = tmodel.get_outputs(field, tb, cfg, training=True, rays_live=False)
    ld = tmodel.get_loss_dict(out, t(gt), tcfg.loss_coefficients_at_step(step))
    sum(ld.values()).backward()
    grads = tckpt.params_to_rsn({
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in field.named_parameters()})
    return ({k: float(v.detach()) for k, v in ld.items()}, n(out["mask"]),
            grads)


@pytest.fixture(scope="module")
def scene():
    tree = rsn_params(4, crafted_normals=True)
    o, d, pa = _rays()
    gt = np.random.default_rng(5).uniform(0, 1, (R, 3)).astype(np.float32)
    return tree, o, d, pa, gt


def _collided(o, d, pa, cfg_t, cfg_j):
    jb, tb = bundles(o, d, pa)
    return M.apply_collider(jb, cfg_j), tmodel.apply_collider(tb, cfg_t)


def test_train_step_fp32_matches_rsn(scene):
    """The plain (fp32) training path: loss dict and every parameter
    gradient against rsn's XLA path, midpoint draws on both sides."""
    tree, o, d, pa, gt = scene
    cfg_j = jcfg.ModelConfig(**_mcfg())
    cfg_t = tcfg.ModelConfig(**_mcfg())
    jb, tb = _collided(o, d, pa, cfg_t, cfg_j)
    lj, mj, gj = _rsn_step(jax_params(tree), jb, jnp.asarray(gt), cfg_j)
    lt, mt, gt_ = _port_step(port_field(tree), tb, gt, cfg_t)
    assert 0 < mj.mean() < 1
    np.testing.assert_array_equal(mt, mj)
    assert set(lt) == set(lj)
    # fp32 sets a floor under two of the comparisons, which rsn's own
    # jitted and eager paths (two op orders) show as well: the analytic
    # normals are a normalized fp32 gradient (the predicted-normal losses
    # differ by 1.4e-4 between them), and trunk layer 0's gradient is
    # 200x smaller than layer 7's, a sum of cancelling terms (3.7e-3)
    normal_losses = ("predicted_normal_loss_coarse",
                     "predicted_normal_loss_fine")
    for k in lj:
        tol = 5e-4 if k in normal_losses else 1e-5
        assert abs(lt[k] - lj[k]) <= tol * max(abs(lj[k]), 1e-6), k
    _assert_grads(gt_, gj, 1e-4, {("trunk", 0): 5e-3})


def test_train_step_bf16_kernel_branch_matches_rsn(scene):
    """The port's kernel branch (K3-K5 plain versions under the autograd
    Function) against rsn with its train kernels in Pallas interpret
    mode (_field_cfg and the kernels patched; rsn itself unchanged)."""
    tree, o, d, pa, gt = scene
    kw = _mcfg(compute_dtype="bfloat16", reflect_ray_fraction=0.5)
    cfg_j = jcfg.ModelConfig(**kw)
    cfg_t = tcfg.ModelConfig(**kw)
    jb, tb = _collided(o, d, pa, cfg_t, cfg_j)
    saved_cfg = M._field_cfg
    kernels = ("field_forward_v6", "field_backward_v5", "field_backward_v6")
    saved = {k: getattr(jft, k) for k in kernels}
    M._field_cfg = lambda cfg: jfield.FieldConfig(
        compute_dtype=jnp.bfloat16, sh_l8_m7_2x=True, use_pallas=True,
        use_pallas_train=True, save_acts=True, pallas_interpret=True)
    for k, fn in saved.items():
        setattr(jft, k, functools.partial(fn, interpret=True))
    try:
        lj, mj, gj = _rsn_step(jax_params(tree), jb, jnp.asarray(gt), cfg_j)
    finally:
        M._field_cfg = saved_cfg
        for k, fn in saved.items():
            setattr(jft, k, fn)
    assert tmodel._field_cfg(cfg_t).use_train_kernels
    lt, mt, gt_ = _port_step(port_field(tree), tb, gt, cfg_t)
    np.testing.assert_array_equal(mt, mj)
    for k in lj:
        assert abs(lt[k] - lj[k]) <= 2e-2 * max(abs(lj[k]), 1e-6), k
    _assert_grads(gt_, gj, 5e-2)


def test_safe_sqrt_backward_is_clamped():
    x = np.array([0.0, 1e-14, 0.25, 4.0], np.float32)
    ref = jax.grad(lambda v: jnp.sum(jrender.safe_sqrt(v)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    y = trender.safe_sqrt(xt)
    y.sum().backward()
    np.testing.assert_array_equal(n(y), np.sqrt(x))
    np.testing.assert_allclose(n(xt.grad), np.asarray(ref), rtol=1e-6)
    assert np.isfinite(n(xt.grad)).all()


def test_matmul_bf16_backward_matches_rsn():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)  # rsn (in, out)
    g = rng.normal(size=(6, 5, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jfield._matmul_bf16(a, b),
                     jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))
    xt = t(x).to(torch.bfloat16).requires_grad_(True)
    wt = t(w.T.copy()).requires_grad_(True)
    y = tfield.MatmulBF16.apply(xt, wt)
    y.backward(t(g))
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(n(xt.grad), np.asarray(dxj, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(n(wt.grad).T, np.asarray(dwj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_analytic_normals_match_rsn(dtype):
    tree = rsn_params(0)
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(32, 3)).astype(np.float32) * 0.5
    cov = np.abs(rng.normal(size=(32, 3))).astype(np.float32) * 1e-2
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jfield.get_analytic_normals(
        jax_params(tree), jnp.asarray(mean), jnp.asarray(cov),
        jfield.FieldConfig(compute_dtype=jd))
    field = port_field(tree)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = field.get_analytic_normals(t(mean), t(cov), td)
    assert all(p.grad is None for p in field.parameters())
    dots = np.sum(n(got) * np.asarray(ref), axis=-1)
    if dtype == "float32":
        assert dots.min() > 1 - 1e-5
    else:  # bf16 chains: hold the bulk, like rsn's own normals test
        assert np.median(dots) > 0.999 and np.mean(dots > 0.99) > 0.9


def test_stratified_pdf_draws():
    """With a generator the PDF u's are jittered within their bins, from
    the generator alone; without one they are the eval midpoints."""
    _, tb = bundles(*_rays())
    tb = tmodel.apply_collider(tb, tcfg.ModelConfig())
    rs = spaced_sample(tb, identity_spacing(), 8)
    w = torch.rand(R, 8, 1, generator=torch.Generator().manual_seed(0))
    mid = pdf_sample(tb, rs, w, identity_spacing(), 8)
    a = pdf_sample(tb, rs, w, identity_spacing(), 8,
                   torch.Generator().manual_seed(1))
    b = pdf_sample(tb, rs, w, identity_spacing(), 8,
                   torch.Generator().manual_seed(1))
    assert torch.equal(a.starts, b.starts)
    assert not torch.equal(a.starts, mid.starts)
    edges = torch.cat([a.spacing_starts[..., 0], a.spacing_ends[..., -1:, 0]],
                      dim=-1)
    assert torch.all(edges[..., 1:] >= edges[..., :-1])


@pytest.mark.parametrize("steps,group", [
    pytest.param(1, "fields", id="1"), pytest.param(10, "fields", id="10"),
    pytest.param(10, "camera_opt", id="camera_opt-10")])
def test_radam_and_schedule_match_optax(steps, group):
    """The "fields" group (RAdam) and the "camera_opt" group (Adam) with
    their decay, at max_steps 20 so that the schedule moves."""
    cfg = dataclasses.replace(jcfg.TrainerConfig().optimizers[group],
                              max_steps=20)
    rng = np.random.default_rng(steps)
    shapes = [(7, 5), (5,), (3, 4)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    opt = joptim.build_optimizer(cfg)
    pj = [jnp.asarray(p) for p in p0]
    state = opt.init(pj)
    for gs in grads:
        upd, state = opt.update([jnp.asarray(g) for g in gs], state, pj)
        pj = [p + u for p, u in zip(pj, upd)]
    pt = [torch.nn.Parameter(t(p)) for p in p0]
    topt, sched = toptim.build_optimizer(
        pt, tcfg.OptimizerGroupConfig(**dataclasses.asdict(cfg)))
    for gs in grads:
        for p, g in zip(pt, gs):
            p.grad = t(g)
        topt.step()
        sched.step()
    # rel 1e-6 of each tensor's max: optax forms the rectification's
    # rho_t = rho_inf - 2 t b2^t / (1 - b2^t) in fp32 (1999 - 1993 at
    # step 6 keeps ~4 digits), torch in double
    for a, b in zip(pt, pj):
        b = np.asarray(b)
        assert np.abs(n(a) - b).max() <= 1e-6 * np.abs(b).max()
    assert sched.get_last_lr()[0] == pytest.approx(
        float(joptim.exponential_decay(cfg.lr, cfg.lr_final, 20)(steps)),
        rel=1e-6)


@pytest.mark.parametrize("scene_name", ["sphere", "triple", "specular",
                                        "glossy", "shinyfloor"])
def test_synthetic_ground_truth_is_rsns_bit_for_bit(scene_name):
    for split in ("train", "test"):
        a = make_synthetic_dataset(num_cameras=2, H=12, W=12, split=split,
                                   scene=scene_name)
        b = rsn_dataset(num_cameras=2, H=12, W=12, split=split,
                        scene=scene_name)
        assert a.images.dtype == b.images.dtype
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_allclose(a.cameras.camera_to_worlds.numpy(),
                                   np.asarray(b.cameras.camera_to_worlds))


def test_config_json_reads_the_same_in_both_packages(tmp_path):
    kw = dict(seed=7, max_num_iterations=60, pipeline=None)
    tc = tcfg.TrainerConfig(**{**kw, "pipeline": tcfg.PipelineConfig(
        model=tcfg.ModelConfig(compute_dtype="bfloat16",
                               reflect_ray_fraction=0.625),
        datamanager=tcfg.DataManagerConfig(dataparser="synthetic",
                                           data="sphere:res=8"))})
    jc = jcfg.TrainerConfig(**{**kw, "pipeline": jcfg.PipelineConfig(
        model=jcfg.ModelConfig(compute_dtype="bfloat16",
                               reflect_ray_fraction=0.625),
        datamanager=jcfg.DataManagerConfig(dataparser="synthetic",
                                           data="sphere:res=8"))})
    tckpt.dump_config(str(tmp_path / "t"), tc)
    jckpt.dump_config(str(tmp_path / "j"), jc)
    assert rsn_load_config(str(tmp_path / "t")) == jc
    assert trun_io.load_config(str(tmp_path / "j")) == tc
    with open(tmp_path / "t" / "config.json") as a, \
            open(tmp_path / "j" / "config.json") as b:
        assert json.load(a) == json.load(b)


def _tiny_config(tmp, **model):
    mcfg = tcfg.ModelConfig(compute_dtype="bfloat16", **_mcfg(**model))
    dm = tcfg.DataManagerConfig(dataparser="synthetic",
                                data="sphere:res=8,cams=2",
                                train_num_rays_per_batch=16)
    return tcfg.TrainerConfig(output_dir=str(tmp), steps_per_log=5,
                              steps_per_save=5, max_num_iterations=10,
                              seed=3, pipeline=tcfg.PipelineConfig(
                                  model=mcfg, datamanager=dm))


def test_trainer_steps_warmup_controller_and_checkpoint(tmp_path):
    for k in tcfg.WARMUP_ZEROED:
        assert tcfg.loss_coefficients_at_step(49)[k] == 0.0
        assert (tcfg.loss_coefficients_at_step(50)[k]
                == tcfg.LOSS_COEFFICIENTS[k])
    config = _tiny_config(tmp_path)
    tr = ttrainer.Trainer(config, run_dir=str(tmp_path / "a"), device="cpu")
    tr.train()
    with open(tmp_path / "a" / "train_log.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [e["step"] for e in log] == [1, 5, 10]
    for e in log:  # before step 50 the normal losses are off
        assert e["orientation_loss_fine"] == 0.0
        assert e["predicted_normal_loss_coarse"] == 0.0
        assert np.isfinite(e["total_loss"]) and e["rays_per_sec"] > 0
    assert sorted(os.listdir(tmp_path / "a" / "checkpoints")) == [
        "step-000000005.pt", "step-000000010.pt"]

    # the controller: raise at once under overflow, relax after 3 votes
    tr._maybe_adapt_reflect_fraction({"mask_fraction": 0.3,
                                      "reflect_overflow": 0.1})
    assert tr._reflect_frac == 0.625
    for _ in range(3):
        tr._maybe_adapt_reflect_fraction({"mask_fraction": 0.1,
                                          "reflect_overflow": 0.0})
    assert tr._reflect_frac == 0.5
    tr._maybe_adapt_reflect_fraction({"mask_fraction": 0.3,
                                      "reflect_overflow": 0.1})
    tr.save()

    # restore: field, optimizer, schedule, step, controller, draws
    tr2 = ttrainer.Trainer(config, run_dir=str(tmp_path / "b"), device="cpu")
    tr2.restore(str(tmp_path / "a" / "checkpoints"))
    assert tr2.step == 10 and tr2._reflect_frac == 0.625
    assert tr2.scheduler.last_epoch == tr.scheduler.last_epoch == 10
    sa, sb = tr.optimizer.state_dict(), tr2.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), k
    tr.train_step()
    tr2.train_step()
    for (k, a), b in zip(tr.field.state_dict().items(),
                         tr2.field.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_cli_writes_a_run_dir(tmp_path, capsys):
    argv = ["reflect-sampling-nerf", "--data", "sphere:res=8,cams=2",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16",
            "--pipeline.datamanager.train-num-rays-per-batch", "16",
            "--pipeline.model.num-coarse-samples", "8",
            "--pipeline.model.num-importance-samples", "8",
            "--pipeline.model.num-reflect-coarse-samples", "8",
            "--pipeline.model.num-reflect-importance-samples", "8",
            "--max-num-iterations", "2", "--steps-per-log", "1",
            "--output-dir", str(tmp_path)]
    assert ttrain_cli.main(argv, device="cpu") == 0
    printed = capsys.readouterr().out
    assert "step 2:" in printed and "mask fraction" in printed
    assert "reflect bucket" in printed and "rays/s" in printed
    (run,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path)
              for d in ds if d == "checkpoints"]
    run = os.path.dirname(run)
    assert trun_io.load_config(run).pipeline.model.compute_dtype == "bfloat16"
    with open(os.path.join(run, "train_log.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert os.listdir(os.path.join(run, "checkpoints")) == [
        "step-000000002.pt"]
    field, _, step, _ = trun_io.load_run_full(run)
    assert step == 2 and isinstance(field, tfield.Field)


def test_train_cli_runs_the_preset(tmp_path, capsys):
    """reflect-sampling-nerf-proposal through the train CLI: the
    interlevel and distortion losses in the log, the proposal field and
    its optimizer in the checkpoint."""
    argv = ["reflect-sampling-nerf-proposal", "--data", "sphere:res=8,cams=2",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16",
            "--pipeline.model.use-pallas-proposal", "true",
            "--pipeline.datamanager.train-num-rays-per-batch", "16",
            "--pipeline.model.num-proposal-samples", "8",
            "--pipeline.model.num-importance-samples", "8",
            "--pipeline.model.num-reflect-coarse-samples", "8",
            "--pipeline.model.num-reflect-importance-samples", "8",
            "--max-num-iterations", "2", "--steps-per-log", "1",
            "--output-dir", str(tmp_path)]
    assert ttrain_cli.main(argv, device="cpu") == 0
    assert "interlevel_loss=" in capsys.readouterr().out
    (run,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path)
              for d in ds if d == "checkpoints"]
    run = os.path.dirname(run)
    mcfg = trun_io.load_config(run).pipeline.model
    assert mcfg.use_proposal and mcfg.use_proposal_reflect
    with open(os.path.join(run, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [e["step"] for e in log] == [1, 2]
    for e in log:
        assert "loss_mid_coarse" not in e
        assert np.isfinite(e["interlevel_loss"])
        assert np.isfinite(e["distortion_loss"])
    _, _, step, extras = trun_io.load_run_full(run)
    assert step == 2 and "proposal" in extras
    state = tckpt.load_checkpoint(os.path.join(
        run, "checkpoints", "step-000000002.pt"))
    assert len(state["proposal_optimizer"]["state"]) == 10


def test_entry_points_need_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttrain_cli.main(["reflect-sampling-nerf", "--data", "sphere:res=8",
                         "--pipeline.datamanager.dataparser", "synthetic",
                         "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        trender_cli.main(["--load-dir", str(tmp_path), "--mode", "orbit"])


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--num-devices", "4"], "mesh", id="flags1-mesh"),
    # the dataparsers are ported; a scene of JPEG frames is not yet
    pytest.param(["--pipeline.datamanager.dataparser", "blender",
                  "--data", "{jpeg_scene}"], "JPEG",
                 id="flags3-dataparser"),
])
def test_unported_train_options_raise(tmp_path, flags, match):
    scene = tmp_path / "jpeg_scene"
    scene.mkdir()
    (scene / "r_0.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    (scene / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.69, "frames": [
            {"file_path": "./r_0.jpg",
             "transform_matrix": np.eye(4).tolist()}]}))
    argv = ["reflect-sampling-nerf", "--data", "sphere:res=8,cams=2",
            "--pipeline.datamanager.dataparser", "synthetic",
            "--pipeline.model.compute-dtype", "bfloat16",
            "--output-dir", str(tmp_path)] + [
                f.format(jpeg_scene=scene) for f in flags]
    with pytest.raises(NotImplementedError, match=match):
        ttrain_cli.main(argv, device="cpu")
