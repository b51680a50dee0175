"""rsn_torch.models.field against rsn.models.field, with the same weights
carried across by params_from_rsn.  Tolerances: fp32 atol 1e-5 (sum
order of 256-deep products); bf16 atol 2e-2 (one bf16 rounding of an
activation near a rounding boundary can flip between the packages)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsn.models import field as jfield
from rsn_torch.engine.checkpoints import params_from_rsn, params_to_rsn
from rsn_torch.models import field as tfield
from torch_parity import jax_params, n, port_field, rsn_params, t

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def weights():
    tree = rsn_params(0)
    return tree, jax_params(tree), port_field(tree)


@pytest.fixture
def inputs():
    rng = np.random.default_rng(1)
    mean = rng.uniform(-1.5, 1.5, size=(48, 3)).astype(np.float32)
    cov = rng.uniform(1e-4, 5e-2, size=(48, 3)).astype(np.float32)
    return rng, mean, cov


def test_params_round_trip_is_exact(weights):
    tree, _, _ = weights
    back = params_to_rsn(params_from_rsn(tree))
    la = jax.tree_util.tree_leaves_with_path(tree)
    lb = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, a), (_, b) in zip(la, lb):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    sd = params_from_rsn(back)
    for k, v in params_from_rsn(tree).items():
        assert torch.equal(v, sd[k]), k


def test_port_init_shapes_and_bounds(weights):
    tree, _, _ = weights
    ref = params_from_rsn(tree)
    field = tfield.Field(torch.Generator().manual_seed(5))
    sd = field.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.shape == ref[k].shape, k
        fan_in = sd[k.replace(".bias", ".weight")].shape[1]
        assert float(v.abs().max()) <= fan_in ** -0.5, k
        if v.numel() > 8:  # not degenerate
            assert float(v.std()) > 0.2 * fan_in ** -0.5, k
    again = tfield.Field(torch.Generator().manual_seed(5)).state_dict()
    other = tfield.Field(torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["mlp_base.layers.0.weight"],
                           other["mlp_base.layers.0.weight"])
    assert "mlp_base.layers.4.weight" in sd and sd[
        "mlp_base.layers.4.weight"].shape == (256, 256 + 99)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_outputs_match(weights, inputs, dtype):
    _, params, field = weights
    _, mean, cov = inputs
    jd, td, atol = DTYPES[dtype]
    cfg = jfield.FieldConfig(compute_dtype=jd)
    ref = jfield.get_field_outputs(params, jnp.asarray(mean),
                                   jnp.asarray(cov), cfg)
    got = field.get_field_outputs(t(mean), t(cov), td)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(n(got[k]), np.asarray(ref[k], np.float32),
                                   atol=atol, rtol=0, err_msg=k)
    dj, embj, pj = jfield.get_density(params, jnp.asarray(mean),
                                      jnp.asarray(cov), cfg)
    dt, embt, pt = field.get_density(t(mean), t(cov), td)
    assert embt.dtype == td
    for a, b, name in ((dt, dj, "density"), (pt, pj, "preact"),
                       (embt, embj, "embedding")):
        np.testing.assert_allclose(n(a), np.asarray(b, np.float32),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mid_factored_low_and_inf_color_match(weights, inputs, dtype):
    _, params, field = weights
    rng, mean, cov = inputs
    jd, td, atol = DTYPES[dtype]
    cfg = jfield.FieldConfig(compute_dtype=jd)
    R, S = 6, 8
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rough = rng.uniform(0, 3, size=(R, S, 1)).astype(np.float32)
    bott = rng.uniform(0, 1, size=(R, S, 256)).astype(np.float32)
    for quirk in (True, False):
        ref = jfield.get_mid_factored(
            params, jnp.asarray(dirs), jnp.asarray(rough),
            jnp.asarray(bott).astype(jd),
            jfield.FieldConfig(compute_dtype=jd, sh_l8_m7_2x=quirk))
        got = field.get_mid_factored(t(dirs), t(rough), t(bott).to(td),
                                     quirk, td)
        np.testing.assert_allclose(n(got), np.asarray(ref, np.float32),
                                   atol=atol, rtol=0, err_msg=str(quirk))
    emb = rng.uniform(0, 1, size=(R, 256)).astype(np.float32)
    np.testing.assert_allclose(
        n(field.get_low(t(emb).to(td), td)),
        np.asarray(jfield.get_low(params, jnp.asarray(emb).astype(jd), True,
                                  cfg), np.float32), atol=atol, rtol=0)
    sqr = rng.uniform(0, 0.05, size=(R, 1)).astype(np.float32)
    np.testing.assert_allclose(
        n(field.get_inf_color(t(dirs), t(sqr), td)),
        np.asarray(jfield.get_inf_color(params, jnp.asarray(dirs),
                                        jnp.asarray(sqr), cfg), np.float32),
        atol=atol, rtol=0)


def test_reflection_and_heads(weights, inputs):
    _, params, field = weights
    rng, _, _ = inputs
    d = rng.normal(size=(5, 7, 3)).astype(np.float32)
    nn = rng.normal(size=(5, 7, 3)).astype(np.float32)
    nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
    rj, ndj = jfield.get_reflection(jnp.asarray(d), jnp.asarray(nn))
    rt, ndt = tfield.get_reflection(t(d), t(nn))
    np.testing.assert_allclose(n(rt), np.asarray(rj), atol=1e-6)
    np.testing.assert_allclose(n(ndt), np.asarray(ndj), atol=1e-6)
    emb = rng.uniform(0, 1, size=(9, 256)).astype(np.float32)
    for name, fn in (("diff", jfield.get_diff), ("tint", jfield.get_tint),
                     ("pred_normals", jfield.get_pred_normals),
                     ("roughness", jfield.get_roughness)):
        ref = fn(params, jnp.asarray(emb))
        got = getattr(field, f"get_{name}")(t(emb))
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-5,
                                   err_msg=name)

