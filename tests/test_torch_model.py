"""rsn_torch's eval-mode get_outputs against rsn.models.model.get_outputs,
with the setup of tests/test_model_kernel_glue.py: crafted normals for a
mixed mask, a 4x4 synthetic camera, 8 samples per pass."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from rsn.configs import ModelConfig
from rsn.data.cameras import generate_image_rays as jrays
from rsn.data.synthetic import make_synthetic_dataset
from rsn.models import model as jmodel
from rsn_torch.models import model as tmodel
from rsn_torch.models.proposal import ProposalField
from torch_parity import bundles, jax_params, n, port_field, rsn_params

GLUE_KEYS = ("mid_rgb_coarse", "mid_rgb_fine", "mid_reflect_coarse",
             "mid_reflect_fine", "accumulation_coarse", "accumulation_fine",
             "diff", "tint", "roughness", "pred_normals_fine", "n_dot_d_fine")


@pytest.fixture(scope="module")
def setup():
    mcfg = ModelConfig(num_coarse_samples=8, num_importance_samples=8,
                       num_reflect_coarse_samples=8,
                       num_reflect_importance_samples=8)
    tree = rsn_params(0, crafted_normals=True)
    ds = make_synthetic_dataset(num_cameras=1, H=4, W=4)
    o, d, pa = (np.asarray(x) for x in jrays(ds.cameras, 0))
    jb, tb = bundles(o, d, pa)
    return mcfg, jax_params(tree), port_field(tree), jb, tb


def _run_both(setup, cfg_j, cfg_t, **kw):
    mcfg, params, field, jb, tb = setup
    out_j = jmodel.get_outputs(params, jb, jax.random.PRNGKey(1), cfg_j,
                               training=False, **kw)
    out_t = tmodel.get_outputs(field, tb, cfg_t, training=False, **kw)
    return out_j, out_t


def test_fp32_path_matches(setup):
    mcfg = dataclasses.replace(setup[0], use_pallas=False)
    out_j, out_t = _run_both(setup, mcfg, mcfg)
    assert set(out_t) == set(out_j)
    mask = np.asarray(out_j["mask"])
    assert 0 < mask.mean() < 1
    np.testing.assert_array_equal(n(out_t["mask"]), mask)
    for k in out_j:
        a, b = n(out_t[k]), np.asarray(out_j[k], np.float32)
        if k == "depth_reflect_fine":  # valid only where mask (SURVEY B#10)
            a, b = a[mask], b[mask]
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=k)


def test_bf16_kernel_branch_matches_pallas_interpret(setup):
    """The port's kernel branch (plain K1/K2 on the CPU) against rsn's
    kernel branch in Pallas interpret mode: bf16 tolerance."""
    cfg_t = dataclasses.replace(setup[0], compute_dtype="bfloat16")
    cfg_j = dataclasses.replace(cfg_t, pallas_interpret=True)
    assert tmodel._field_cfg(cfg_t).use_kernels
    out_j, out_t = _run_both(setup, cfg_j, cfg_t)
    assert set(out_t) == set(out_j)
    np.testing.assert_array_equal(n(out_t["mask"]), np.asarray(out_j["mask"]))
    for k in GLUE_KEYS:
        np.testing.assert_allclose(n(out_t[k]),
                                   np.asarray(out_j[k], np.float32),
                                   atol=0.05, rtol=0.05, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_density_only_coarse_is_bit_identical_downstream(setup, dtype):
    mcfg, _, field, _, tb = setup
    cfg = dataclasses.replace(mcfg, compute_dtype=dtype)
    assert tmodel._field_cfg(cfg).use_kernels == (dtype == "bfloat16")
    full = tmodel.get_outputs(field, tb, cfg)
    dens = tmodel.get_outputs(field, tb, cfg, need_coarse_rgb=False)
    dropped = {"pred_normals_coarse", "normals_coarse", "n_dot_d_coarse",
               "mid_reflect_coarse"}
    assert set(dens) == set(full) - dropped
    for k in dens:
        if k != "mid_rgb_coarse":  # background fill by contract
            assert torch.equal(dens[k], full[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_compaction_equals_full_when_mask_fits(setup, dtype):
    mcfg, _, field, _, tb = setup
    full_cfg = dataclasses.replace(mcfg, compute_dtype=dtype)
    out_f = tmodel.get_outputs(field, tb, full_cfg)
    frac = float(out_f["mask"].float().mean())
    assert 0 < frac <= 0.5
    cap_cfg = dataclasses.replace(full_cfg, eval_reflect_ray_fraction=0.75)
    out_c = tmodel.get_outputs(field, tb, cap_cfg)
    assert float(out_c["reflect_overflow"]) == 0.0
    for k in ("mid_reflect_coarse", "mid_reflect_fine"):
        np.testing.assert_allclose(n(out_c[k]), n(out_f[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    m = n(out_f["mask"]).astype(bool)
    np.testing.assert_allclose(n(out_c["depth_reflect_fine"])[m],
                               n(out_f["depth_reflect_fine"])[m], atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_operands_packed_by_the_caller_change_nothing(setup, dtype):
    """render_image packs the kernels' weights once per frame and hands
    them to every chunk's get_outputs: the same outputs, bit for bit."""
    mcfg, _, field, _, tb = setup
    cfg = dataclasses.replace(mcfg, compute_dtype=dtype)
    packed = tmodel.pack_kernel_operands(field, cfg)
    assert (packed is None) == (dtype == "float32")
    own = tmodel.get_outputs(field, tb, cfg)
    given = tmodel.get_outputs(field, tb, cfg, packed=packed)
    assert set(given) == set(own)
    for k in own:
        assert torch.equal(given[k], own[k]), k


def test_compaction_selection_matches_jax_top_k():
    mask = torch.tensor([0, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    sel = torch.sort(mask.float(), descending=True, stable=True).indices[:3]
    _, ref = jax.lax.top_k(np.asarray(mask, np.float32), 3)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref))


def test_unported_modes_raise(setup):
    mcfg, _, field, _, tb = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.get_outputs(field, tb, dataclasses.replace(
            mcfg, compute_dtype="bfloat16", use_pallas_acts=False),
            training=True)


@pytest.mark.parametrize("training", [False, True])
def test_proposal_mode_runs(setup, training):
    """use_proposal with a proposal field runs passes 1 and 3 on it; a
    use_proposal config without one runs the main field's coarse pass,
    as rsn does."""
    mcfg, _, field, _, tb = setup
    cfg = dataclasses.replace(mcfg, use_proposal=True,
                              use_proposal_reflect=True,
                              num_proposal_samples=8)
    prop = ProposalField(torch.Generator().manual_seed(0))
    out = tmodel.get_outputs(field, tb, cfg, training=training,
                             proposal=prop)
    assert {"prop_weights", "reflect_prop_weights"} <= set(out)
    assert "mid_reflect_coarse" not in out
    assert torch.isfinite(tmodel.final_rgb(out)).all()
    without = tmodel.get_outputs(field, tb, cfg, training=training)
    ref = tmodel.get_outputs(field, tb, mcfg, training=training)
    assert set(without) == set(ref)
    for k in ref:
        assert torch.equal(without[k], ref[k]), k
