"""rsn_torch's proposal preset (reflect-sampling-nerf-proposal) against
rsn's on the CPU, with one weight tree and numpy inputs fed to both: K9's
plain version against rsn's prop_forward in Pallas interpret mode, the
fp32 proposal density and losses, the weight carry, the Adam group, the
preset's eval render and train step (fp32, and the bf16 kernel branch),
and a tiny preset run through the trainer, its checkpoint and the render
CLI."""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rsn.configs as jcfg
from rsn.core import contract as jcontract
from rsn.core import spacing as jspacing
from rsn.data.cameras import generate_image_rays as jrays
from rsn.data.synthetic import make_synthetic_dataset
from rsn.engine import optimizers as joptim
from rsn.kernels import field_train as jft
from rsn.kernels import proposal_pallas as jpp
from rsn.models import field as jfield
from rsn.models import model as M
from rsn.models import proposal as jprop
import rsn_torch.configs as tcfg
from rsn_torch.cli import render as trender_cli
from rsn_torch.cli import run_io as trun_io
from rsn_torch.core import spacing as tspacing
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.engine import optimizers as toptim
from rsn_torch.engine import trainer as ttrainer
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import proposal_forward as pf
from rsn_torch.models import model as tmodel
from rsn_torch.models import proposal as tprop
from torch_parity import (assert_grads as _assert_grads, bundles,
                          jax_params, n, port_field, rsn_params, t)

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny steps on one thread: beside the suite's other workers, a
    thread pool per core makes each small op wait on the others (as in
    tests/test_torch_trainer_obs.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPACINGS = {"identity": (jspacing.identity_spacing(),
                         tspacing.identity_spacing()),
            "reciprocal": (jspacing.reciprocal_spacing(0.25),
                           tspacing.reciprocal_spacing(0.25))}


def prop_tree(seed: int = 0):
    return jax.tree.map(np.asarray,
                        jprop.init_proposal_params(jax.random.PRNGKey(seed)))


def port_prop(tree) -> tprop.ProposalField:
    prop = tprop.ProposalField()
    prop.load_state_dict(tckpt.proposal_from_rsn(tree))
    return prop


def _samples(spacing: str, S: int, R: int = 16, seed: int = 3):
    """The same frusta in both packages: rays from z = 4 in numpy
    directions, pixel area 1e-4 (tests/test_proposal_kernel.py's)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (R, 3)).copy()
    pa = np.full((R, 1), 1e-4, np.float32)
    jb, tb = bundles(o, d, pa)
    js, ts = SPACINGS[spacing]
    return (jspacing.spaced_sample(jb, js, S, key=None),
            tspacing.spaced_sample(tb, ts, S))


# ---- K9: packing, IPE, plain version ------------------------------------

def test_packed_operands_equal_rsn():
    tree = prop_tree(0)
    jpack = jpp.pack_prop_params(jax_params(tree))
    tpack = pf.pack_prop_params(port_prop(tree))
    assert len(jpack) == len(tpack) == len(pf.PROP_SHAPES)
    for i, (a, b) in enumerate(zip(jpack, tpack)):
        want = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert b.dtype == want, i
        np.testing.assert_array_equal(n(b), np.asarray(a.astype(jnp.float32)),
                                      err_msg=str(i))


def test_ipe_rounds_as_rsns_constant_matrices():
    """prop_ipe against rsn's in-kernel formula M * exp(-var/2) sin(pre)
    + (1 - M) pre, pre = mc @ A + bA, var = mc @ V, on rsn's constant
    matrices: one nonzero term per column, so each product is rounded
    once to fp32 (numpy, elementwise), then the fp32 pi/2 added; the sine
    and exp in float64.  Within 2e-6, where a phase one ulp off (2.4e-4
    rad at 3.2e3 rad) would show."""
    rng = np.random.default_rng(4)
    mc = np.zeros((256, 16), np.float32)
    mc[:, 0:3] = rng.uniform(-2.0, 2.0, size=(256, 3))
    mc[:, 3:6] = rng.uniform(0.0, 1e-5, size=(256, 3))
    A, bA, V, Mm = (np.asarray(m) for m in jpp.prop_ipe_matrices())
    pre = (mc[:, :, None] * A[None]).sum(axis=1, dtype=np.float32) + bA
    var = (mc[:, :, None] * V[None]).sum(axis=1, dtype=np.float32)
    assert pre.dtype == var.dtype == np.float32
    ref = Mm * (np.exp(-0.5 * var.astype(np.float64))
                * np.sin(pre.astype(np.float64))) + (1.0 - Mm) * pre
    np.testing.assert_allclose(n(pf.prop_ipe(t(mc))), ref, rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("spacing,S,R", [("identity", 16, 16),
                                         ("reciprocal", 8, 16),
                                         ("identity", 16, 13)])
def test_prop_forward_plain_matches_pallas_interpret(spacing, S, R):
    """On the same packed operands and (N, 16) rows: max |d preact| within
    1e-2 of max |preact| (bf16 activations: an accumulation-order flip of
    one rounding moves a row by an ulp of its activations).  R = 13 gives
    208 rows, a ragged last tile (rsn's side is padded to its tile)."""
    tree = prop_tree(1)
    js, _ = _samples(spacing, S, R)
    mc = np.asarray(jcontract.packed_contract_planes(js, 16))
    N = mc.shape[0]
    pad = -(-N // 64) * 64
    ref = jpp.prop_forward(jpp.pack_prop_params(jax_params(tree)),
                           jnp.asarray(np.pad(mc, ((0, pad - N), (0, 0)))),
                           tile=64, interpret=True)[:N]
    got = pf.prop_forward(pf.pack_prop_params(port_prop(tree)), t(mc))
    assert got.dtype == torch.float32 and got.shape == (N,)
    ref = np.asarray(ref)
    assert np.abs(n(got) - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("spacing,S", [("identity", 16), ("reciprocal", 8)])
def test_proposal_density_kernel_matches_rsn(spacing, S):
    """The render path's proposal density (plain K9 here) against rsn's in
    interpret mode, at rsn's own bound (tests/test_proposal_kernel.py)."""
    tree = prop_tree(0)
    js, ts = _samples(spacing, S)
    ref = np.asarray(jpp.proposal_density_kernel(jax_params(tree), js,
                                                 interpret=True))
    got = pf.proposal_density_kernel(pf.pack_prop_params(port_prop(tree)), ts)
    assert got.shape == ref.shape
    np.testing.assert_allclose(n(got), ref, rtol=0.03, atol=0.02)
    assert (n(got) >= 0).all()


def test_prop_forward_cpu_takes_the_plain_version_and_checks_inputs():
    prop = tprop.ProposalField(torch.Generator().manual_seed(0))
    packed = pf.pack_prop_params(prop)
    mc = torch.zeros(70, 16)
    mc[:, :6] = torch.rand(70, 6, generator=torch.Generator().manual_seed(1))
    ff.reset_launch_counts()
    assert torch.equal(pf.prop_forward(packed, mc),
                       pf.prop_forward_plain(packed, mc))
    assert ff.LAUNCHES["prop_forward"] == 0
    with pytest.raises(ValueError):  # empty
        pf.prop_forward(packed, mc[:0])
    with pytest.raises(TypeError):   # f64 rows
        pf.prop_forward(packed, mc.double())
    with pytest.raises(ValueError):  # wrong operand count
        pf.prop_forward(packed[:-1], mc)
    meta = [p.to("meta") for p in packed]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no fallback
        pf.prop_forward(meta, mc.to("meta"))


# ---- the fp32 proposal and its losses -----------------------------------

@pytest.mark.parametrize("spacing,S", [("identity", 16), ("reciprocal", 8)])
def test_proposal_density_matches_rsn(spacing, S):
    tree = prop_tree(2)
    js, ts = _samples(spacing, S)
    ref = np.asarray(jprop.proposal_density(jax_params(tree), js))
    got = n(tprop.proposal_density(port_prop(tree), ts))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def _histograms(seed: int = 0, R: int = 6, Sf: int = 12, Sp: int = 7):
    rng = np.random.default_rng(seed)

    def edges(k):
        e = np.sort(rng.uniform(0, 1, size=(R, k + 1)), axis=-1)
        e[:, 0], e[:, -1] = 0.0, 1.0
        return e.astype(np.float32)

    w_f = rng.dirichlet(np.ones(Sf), size=R).astype(np.float32)[..., None]
    w_p = rng.dirichlet(np.ones(Sp), size=R).astype(np.float32)[..., None]
    return w_f, edges(Sf), w_p, edges(Sp)


def test_interlevel_loss_and_gradient_match_rsn():
    w_f, b_f, w_p, b_p = _histograms()
    args = [jnp.asarray(a) for a in (w_f, b_f, w_p, b_p)]
    ref, gref = jax.value_and_grad(
        lambda wp: jprop.interlevel_loss(args[0], args[1], wp, args[3]))(
        args[2])
    wpt = t(w_p).requires_grad_(True)
    wft = t(w_f).requires_grad_(True)
    got = tprop.interlevel_loss(wft, t(b_f), wpt, t(b_p))
    got.backward()
    assert float(ref) > 0
    assert abs(float(got.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    np.testing.assert_allclose(n(wpt.grad), np.asarray(gref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gref).max()))
    assert wft.grad is None  # the fine side is detached


def test_distortion_and_gradient_match_rsn():
    w_f, b_f, _, _ = _histograms(1)
    per_ray = jax.value_and_grad(
        lambda w, b: jprop.distortion_per_ray(w[None], b[None])[0])
    ref, gref = jax.vmap(per_ray)(jnp.asarray(w_f), jnp.asarray(b_f))
    wt = t(w_f).requires_grad_(True)
    got = tprop.distortion_per_ray(wt, t(b_f))
    got.sum().backward()
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(n(wt.grad), np.asarray(gref), rtol=1e-5,
                               atol=1e-6)


def test_weight_carry_round_trips_bit_for_bit():
    tree = prop_tree(3)
    back = tckpt.proposal_to_rsn(tckpt.proposal_from_rsn(tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    prop = tprop.ProposalField(torch.Generator().manual_seed(5))
    again = port_prop(tckpt.proposal_to_rsn(prop.state_dict()))
    for (k, a), b in zip(prop.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    # the init draws rsn's distribution: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for layer in list(prop.trunk) + [prop.density]:
        bound = 1.0 / layer.weight.shape[1] ** 0.5
        assert float(layer.weight.detach().abs().max()) <= bound
        assert float(layer.bias.detach().abs().max()) <= bound


@pytest.mark.parametrize("steps", [1, 10])
def test_proposal_adam_group_matches_optax(steps):
    """The proposal_networks group: Adam and its exponential decay."""
    cfg = jcfg.TrainerConfig().optimizers["proposal_networks"]
    cfg = dataclasses.replace(cfg, max_steps=20)
    assert cfg.optimizer == "adam"
    rng = np.random.default_rng(steps)
    shapes = [(64, 51), (64,), (1, 64)]
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
    assert isinstance(topt, torch.optim.Adam)
    for gs in grads:
        for p, g in zip(pt, gs):
            p.grad = t(g)
        topt.step()
        sched.step()
    for a, b in zip(pt, pj):
        b = np.asarray(b)
        assert np.abs(n(a) - b).max() <= 1e-6 * np.abs(b).max()
    assert sched.get_last_lr()[0] == pytest.approx(
        float(joptim.exponential_decay(1e-3, 1e-4, 20)(steps)), rel=1e-6)


# ---- the preset's model: eval render and train step ---------------------

PRESET = dict(num_coarse_samples=8, num_importance_samples=8,
              num_reflect_coarse_samples=8, num_reflect_importance_samples=8,
              num_proposal_samples=8, use_proposal=True,
              use_proposal_reflect=True, distortion_loss_mult=0.002)


@pytest.fixture(scope="module")
def eval_setup():
    """tests/test_torch_model.py's: crafted normals split a 4x4 synthetic
    camera's rays into reflecting ones and others."""
    tree = rsn_params(0, crafted_normals=True)
    ptree = prop_tree(0)
    ds = make_synthetic_dataset(num_cameras=1, H=4, W=4)
    o, d, pa = (np.asarray(x) for x in jrays(ds.cameras, 0))
    jb, tb = bundles(o, d, pa)
    return tree, ptree, jb, tb


def _eval_both(setup, cfg_j, cfg_t):
    tree, ptree, jb, tb = setup
    out_j = M.get_outputs(jax_params(tree), jb, jax.random.PRNGKey(1), cfg_j,
                          training=False, prop_params=jax_params(ptree))
    out_t = tmodel.get_outputs(port_field(tree), tb, cfg_t,
                               proposal=port_prop(ptree))
    return out_j, out_t


def test_preset_eval_fp32_matches_rsn(eval_setup):
    cfg = jcfg.ModelConfig(**PRESET)
    out_j, out_t = _eval_both(eval_setup, cfg, tcfg.ModelConfig(**PRESET))
    assert set(out_t) == set(out_j)
    assert "prop_weights" in out_t and "mid_reflect_coarse" not in out_t
    mask = np.asarray(out_j["mask"])
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(n(out_t["mask"]), mask)
    for k in out_j:
        a, b = n(out_t[k]), np.asarray(out_j[k], np.float32)
        if k == "depth_reflect_fine":  # valid only where mask (SURVEY B#10)
            a, b = a[mask], b[mask]
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=k)


def test_preset_eval_bf16_kernel_branch_matches_rsn_interpret(eval_setup):
    """The port's kernel branch (plain K9 and K1 on the CPU) against rsn's
    with K9 and K1 in Pallas interpret mode."""
    kw = dict(PRESET, compute_dtype="bfloat16", use_pallas_proposal=True)
    cfg_t = tcfg.ModelConfig(**kw)
    cfg_j = jcfg.ModelConfig(**kw, pallas_interpret=True)
    assert tmodel._use_prop_kernel(cfg_t, tmodel._field_cfg(cfg_t))
    out_j, out_t = _eval_both(eval_setup, cfg_j, cfg_t)
    assert set(out_t) == set(out_j)
    np.testing.assert_array_equal(n(out_t["mask"]), np.asarray(out_j["mask"]))
    np.testing.assert_allclose(n(tmodel.final_rgb(out_t)),
                               np.asarray(M.final_rgb(out_j)), atol=0.05)
    ff.reset_launch_counts()
    packed = tmodel.pack_kernel_operands(port_field(eval_setup[0]), cfg_t,
                                         port_prop(eval_setup[1]))
    assert packed.proposal is not None
    assert set(ff.LAUNCHES.values()) == {0}  # CPU tensors: plain versions


R = 16


def _train_rays():
    """tests/test_torch_train.py's rays: half look at the scene."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: R // 2, 2] = -np.abs(d[: R // 2, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), (R, 3)).copy()
    return o, d, np.full((R, 1), 1e-6, np.float32)


def _jax_anneal(mcfg, step):
    """rsn make_train_step's anneal, traced in float32."""
    frac = jnp.clip(jnp.int32(step).astype(jnp.float32)
                    / mcfg.proposal_weights_anneal_max_num_iters, 0.0, 1.0)
    s = mcfg.proposal_weights_anneal_slope
    return (s * frac) / ((s - 1.0) * frac + 1.0)


def _rsn_preset_step(params, prop, jb, gt, cfg, step):
    """rsn's loss dict and grads of field and proposal, jitter off."""
    spaced, pdf = M.spaced_sample, M.pdf_sample
    M.spaced_sample = lambda b, s, k, key=None, **kw: spaced(b, s, k, **kw)
    M.pdf_sample = lambda b, rs, w, s, k, key=None, **kw: pdf(b, rs, w, s,
                                                             k, **kw)
    coeffs = dict(jcfg.loss_coefficients_at_step(step),
                  interlevel_loss=jnp.float32(cfg.interlevel_loss_mult),
                  distortion_loss=jnp.float32(cfg.distortion_loss_mult))
    try:
        def total(p, q):
            out = M.get_outputs(p, jb, jax.random.PRNGKey(0), cfg,
                                training=True, prop_params=q,
                                prop_anneal=_jax_anneal(cfg, step),
                                rays_live=False)
            ld = M.get_loss_dict(out, gt, coeffs)
            return sum(jax.tree.leaves(ld)), (ld, out["mask"])

        (_, (ld, mask)), grads = jax.jit(jax.value_and_grad(
            total, argnums=(0, 1), has_aux=True))(params, prop)
    finally:
        M.spaced_sample, M.pdf_sample = spaced, pdf
    return ({k: float(v) for k, v in ld.items()}, np.asarray(mask),
            jax.tree.map(np.asarray, grads))


def _port_preset_step(field, prop, tb, gt, cfg, step):
    out = tmodel.get_outputs(field, tb, cfg, training=True, rays_live=False,
                             proposal=prop,
                             prop_anneal=ttrainer.proposal_anneal(cfg, step))
    ld = tmodel.get_loss_dict(out, t(gt),
                              ttrainer.loss_coefficients(cfg, step))
    sum(ld.values()).backward()

    def grads(module, to_rsn):
        return to_rsn({k: (p.grad if p.grad is not None
                           else torch.zeros_like(p))
                       for k, p in module.named_parameters()})

    return ({k: float(v.detach()) for k, v in ld.items()}, n(out["mask"]),
            (grads(field, tckpt.params_to_rsn),
             grads(prop, tckpt.proposal_to_rsn)))


@pytest.fixture(scope="module")
def train_setup():
    tree = rsn_params(4, crafted_normals=True)
    ptree = prop_tree(4)
    o, d, pa = _train_rays()
    gt = np.random.default_rng(5).uniform(0, 1, (R, 3)).astype(np.float32)
    return tree, ptree, o, d, pa, gt


def _train_both(train_setup, kw, step=100):
    tree, ptree, o, d, pa, gt = train_setup
    cfg_j, cfg_t = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    jb, tb = bundles(o, d, pa)
    jb, tb = M.apply_collider(jb, cfg_j), tmodel.apply_collider(tb, cfg_t)
    anneal = ttrainer.proposal_anneal(cfg_t, step)
    assert 0.0 < anneal < 1.0
    assert anneal == float(_jax_anneal(cfg_j, step))
    ref = _rsn_preset_step(jax_params(tree), jax_params(ptree), jb,
                           jnp.asarray(gt), cfg_j, step)
    got = _port_preset_step(port_field(tree), port_prop(ptree), tb, gt,
                            cfg_t, step)
    return got, ref


def test_preset_train_step_fp32_matches_rsn(train_setup):
    """The 6 losses and every gradient of field and proposal, fp32 plain
    path, midpoint draws on both sides, step 100 (anneal below 1)."""
    (lt, mt, (gf, gp)), (lj, mj, (jf, jp)) = _train_both(train_setup,
                                                         PRESET)
    assert 0 < mj.mean() < 1
    np.testing.assert_array_equal(mt, mj)
    assert set(lt) == set(lj) == {
        "loss_mid_fine", "predicted_normal_loss_fine",
        "orientation_loss_fine", "loss_reflect_mid_fine", "interlevel_loss",
        "distortion_loss"}
    # the predicted-normal loss is a normalized fp32 gradient (rsn's own
    # jitted and eager paths differ by 1.4e-4 there, test_torch_train.py)
    for k in lj:
        tol = 5e-4 if k == "predicted_normal_loss_fine" else 1e-5
        assert abs(lt[k] - lj[k]) <= tol * max(abs(lj[k]), 1e-6), k
    assert lj["interlevel_loss"] > 0 and lj["distortion_loss"] > 0
    # exceptions, each a sum of cancelling fp32 terms: trunk layer 0 (as in
    # test_torch_train.py) and the roughness head, which in the preset
    # reaches the loss only through pass 4's cone radius and the far-field
    # colour: its gradient is 2.6e-8, five orders below the others, and
    # rsn's own jitted and eager paths differ there by 5.0e-4 of its max
    _assert_grads(gf, jf, 1e-4, {("trunk", 0): 5e-3, ("roughness", 0): 2e-3})
    _assert_grads(gp, jp, 1e-4)


def test_preset_train_step_bf16_kernel_branch_matches_rsn(train_setup):
    """The port's training kernel branch (plain K3-K5 under the autograd
    Function, the fp32 proposal) against rsn's with its train kernels in
    Pallas interpret mode (_field_cfg and the kernels patched)."""
    kw = dict(PRESET, compute_dtype="bfloat16", reflect_ray_fraction=0.5)
    saved_cfg = M._field_cfg
    kernels = ("field_forward_v6", "field_backward_v5", "field_backward_v6")
    saved = {k: getattr(jft, k) for k in kernels}
    M._field_cfg = lambda cfg: jfield.FieldConfig(
        compute_dtype=jnp.bfloat16, sh_l8_m7_2x=True, use_pallas=True,
        use_pallas_train=True, save_acts=True, pallas_interpret=True)
    for k, fn in saved.items():
        setattr(jft, k, functools.partial(fn, interpret=True))
    try:
        (lt, mt, (gf, gp)), (lj, mj, (jf, jp)) = _train_both(train_setup, kw)
    finally:
        M._field_cfg = saved_cfg
        for k, fn in saved.items():
            setattr(jft, k, fn)
    np.testing.assert_array_equal(mt, mj)
    assert set(lt) == set(lj)
    for k in lj:
        assert abs(lt[k] - lj[k]) <= 2e-2 * max(abs(lj[k]), 1e-6), k
    # the roughness head's gradient (2.8e-8, see the fp32 test) comes here
    # through pass 4's cone radius (K4's mean/cov backward, whose cov
    # columns test_torch_train_kernels.py holds on equal inputs) and the
    # far-field colour, a sum of cancelling terms over bf16 activations:
    # the port reads 7.9e-2 of its max, held at 1e-1
    _assert_grads(gf, jf, 5e-2, {("roughness", 0): 1e-1})
    _assert_grads(gp, jp, 5e-2)
    # against rsn's fp32 gradient of the same step, the port's bf16 branch
    # is no more than twice as far as rsn's own (+ 1e-4 of the max): on the
    # roughness head rsn's bf16 gradient is 1.5e-1 of its max from its fp32
    # one, the port's 2.5e-1
    tree, ptree, o, d, pa, gt = train_setup
    cfg32 = jcfg.ModelConfig(**dict(kw, compute_dtype="float32"))
    jb, _ = bundles(o, d, pa)
    _, m32, (f32, p32) = _rsn_preset_step(
        jax_params(tree), jax_params(ptree), M.apply_collider(jb, cfg32),
        jnp.asarray(gt), cfg32, 100)
    np.testing.assert_array_equal(m32, mj)
    for got, ref, exact in ((gf, jf, f32), (gp, jp, p32)):
        for name in exact:
            trio = [g[name] if isinstance(g[name], list) else [g[name]]
                    for g in (got, ref, exact)]
            for i, (a, b, e) in enumerate(zip(*trio)):
                for k in ("w", "b"):
                    scale = max(float(np.abs(e[k]).max()), 1e-12)
                    port = float(np.abs(a[k] - e[k]).max()) / scale
                    own = float(np.abs(b[k] - e[k]).max()) / scale
                    assert port <= 2.0 * own + 1e-4, (name, i, k, port, own)


def test_interlevel_gradient_reaches_only_the_proposal(train_setup):
    tree, ptree, o, d, pa, _ = train_setup
    cfg = tcfg.ModelConfig(**PRESET)
    _, tb = bundles(o, d, pa)
    field, prop = port_field(tree), port_prop(ptree)
    out = tmodel.get_outputs(field, tmodel.apply_collider(tb, cfg), cfg,
                             training=True, rays_live=False, proposal=prop,
                             prop_anneal=ttrainer.proposal_anneal(cfg, 100))
    loss = tmodel.get_loss_dict(out, torch.zeros(R, 3), {
        k: 0.0 for k in tmodel.PHOTOMETRIC_LOSS_KEYS
        | tmodel.NON_PHOTOMETRIC_LOSS_KEYS} | {"interlevel_loss": 1.0})
    assert float(loss["interlevel_loss"].detach()) > 0
    loss["interlevel_loss"].backward()
    assert all(p.grad is None for p in field.parameters())
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in prop.parameters())


# ---- the trainer, its checkpoint, the render CLI ------------------------

def _tiny_preset_config(tmp):
    mcfg = tcfg.ModelConfig(compute_dtype="bfloat16",
                            use_pallas_proposal=True, **PRESET)
    dm = tcfg.DataManagerConfig(dataparser="synthetic",
                                data="sphere:res=8,cams=2",
                                train_num_rays_per_batch=16)
    return tcfg.TrainerConfig(
        method_name="reflect-sampling-nerf-proposal", output_dir=str(tmp),
        steps_per_log=5, steps_per_save=5, max_num_iterations=10, seed=3,
        pipeline=tcfg.PipelineConfig(model=mcfg, datamanager=dm))


def test_preset_trainer_checkpoint_restore_and_render(tmp_path, capsys,
                                                      monkeypatch):
    config = _tiny_preset_config(tmp_path)
    tr = ttrainer.Trainer(config, run_dir=str(tmp_path / "a"), device="cpu")
    assert isinstance(tr.proposal, tprop.ProposalField)
    assert isinstance(tr.prop_optimizer, torch.optim.Adam)
    init = {k: v.clone() for k, v in tr.proposal.state_dict().items()}
    tr.train()
    assert any(not torch.equal(init[k], v)
               for k, v in tr.proposal.state_dict().items())
    state = tckpt.load_checkpoint(str(tmp_path / "a" / "checkpoints"
                                      / "step-000000010.pt"))
    assert {"proposal", "proposal_optimizer",
            "proposal_scheduler"} <= set(state)

    tr2 = ttrainer.Trainer(config, run_dir=str(tmp_path / "b"), device="cpu")
    tr2.restore(str(tmp_path / "a" / "checkpoints"))
    assert tr2.step == 10 and tr2.prop_scheduler.last_epoch == 10
    sa, sb = tr.prop_optimizer.state_dict(), tr2.prop_optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][k])), k
    tr.train_step()
    tr2.train_step()
    for module, other in ((tr.field, tr2.field), (tr.proposal, tr2.proposal)):
        for (k, a), b in zip(module.state_dict().items(),
                             other.state_dict().values()):
            assert torch.equal(a, b), k

    field, _, step, extras = trun_io.load_run_full(str(tmp_path / "a"))
    assert step == 10 and isinstance(extras["proposal"], tprop.ProposalField)
    frames = tmp_path / "frames"
    calls = []
    real = pf.proposal_density_kernel
    monkeypatch.setattr(pf, "proposal_density_kernel",
                        lambda p, rs: calls.append(rs) or real(p, rs))
    capsys.readouterr()
    assert trender_cli.main(["--load-dir", str(tmp_path / "a"), "--mode",
                             "orbit", "--num-frames", "1", "--output-dir",
                             str(frames)], device="cpu") == 0
    assert os.listdir(frames) == ["frame_00000.png"]
    assert "rendered 1/1" in capsys.readouterr().out
    assert len(calls) == 2  # passes 1 and 3 of the one 64-ray chunk
