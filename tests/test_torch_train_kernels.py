"""The training kernels' plain versions (K3 field_forward_v6, K4
field_backward_v5, K5 field_backward_v6) and the autograd Function (K6)
against rsn's Pallas kernels in interpret mode, on the same numpy inputs
(R=8 rays, S=8 samples, 32-row tiles on the JAX side)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn_torch.engine.checkpoints import params_to_rsn
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from torch_parity import jax_params, n, port_field, rsn_params, t

R, S = 8, 8
N = R * S
TILE = 32
TOL = 2e-2  # bf16 products, fp32 sums in another order


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(N, 3)).astype(np.float32) * 0.5
    cov = np.abs(rng.normal(size=(N, 3))).astype(np.float32) * 1e-2
    mc = np.zeros((N, 16), np.float32)
    mc[:, :3], mc[:, 3:6] = mean, cov
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jax_params(tree)
    field = port_field(tree)
    g = fp.mid_g_bands(params, jnp.asarray(dirs))
    d_out = rng.normal(size=(N, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:20] = 0.0  # auxiliary columns: dead by contract
    return dict(tree=tree, params=params, field=field, mc=mc,
                g=np.asarray(g), d_out=d_out)


def _port_packed(s, normals=False):
    p = ff.pack_params_v3f(s["field"])
    return tft.pack_params_v4f(p, s["field"]) if normals else p


def _jax_fwd(s, normals, spill_x):
    packed = (fp.pack_params_v4f(s["params"]) if normals
              else fp.pack_params_v3f(s["params"]))
    return fp.field_forward_v6(packed, jnp.asarray(s["mc"]),
                               jnp.asarray(s["g"]), S, tile=TILE,
                               want_normals=normals, interpret=True,
                               spill_x=spill_x)


def _close(got, ref, name, tol=TOL):
    got, ref = n(got), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("normals,spill_x", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_k3_plain_matches_field_forward_v6(setup, normals, spill_x):
    s = setup
    out_j, acts_j = _jax_fwd(s, normals, spill_x)
    out_t, acts_t = tft.field_forward_v6(_port_packed(s, normals), t(s["mc"]),
                                         t(s["g"]), S, normals, spill_x)
    assert out_t.shape == (N, tft.OUT_TRAIN) and out_t.dtype == torch.bfloat16
    oj = np.asarray(out_j, np.float32)
    for cols in (slice(0, 14), tft.V3_MIDVAL):
        np.testing.assert_allclose(n(out_t)[:, cols], oj[:, cols], atol=TOL,
                                   rtol=TOL)
    if normals:
        dj, dt = oj[:, tft.V4_DPDM], n(out_t)[:, tft.V4_DPDM]
        unit = lambda v: -v / np.maximum(
            np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        np.testing.assert_allclose(unit(dt), unit(dj), atol=TOL)
        live = np.linalg.norm(dj, axis=-1) > 1e-3
        assert live.any()
        cos = np.sum(unit(dt) * unit(dj), axis=-1)[live]
        assert cos.min() >= 0.999, cos.min()
    else:
        assert np.all(n(out_t)[:, tft.V4_DPDM] == 0)
    assert acts_t.shape == tuple(acts_j.shape)
    aj = np.asarray(acts_j, np.float32)
    at = n(acts_t)
    ulp = np.maximum(np.abs(aj), 1e-30) * 2.0 ** -7  # one bf16 ulp
    assert np.mean(np.abs(at - aj) <= ulp) >= 0.999


def test_k4_plain_matches_field_backward_v5(setup):
    s = setup
    out_j, acts_j = _jax_fwd(s, False, False)
    packed_j = fp.pack_params_v3f(s["params"])
    d_out = jnp.asarray(s["d_out"]).astype(jnp.bfloat16)
    dmc_j, dg_j, dpk_j = jft.field_backward_v5(
        packed_j, jnp.asarray(s["mc"]), jnp.asarray(s["g"]), acts_j, d_out,
        out_j, S, tile=TILE, inner=2, interpret=True)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                      ).to(torch.bfloat16).contiguous()
    dmc_t, dg_t, dpk_t = tft.field_backward_v5(
        _port_packed(s), t(s["mc"]), t(s["g"]), to_t(acts_j),
        to_t(d_out[:, :tft.OUT_TRAIN]), to_t(out_j[:, :tft.OUT_TRAIN]), S)
    _close(dmc_t, dmc_j, "dmc")
    # the cov columns on their own scale: through them alone a cone
    # radius (pass 4's, from the roughness head) gets its gradient
    _close(dmc_t[:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    _close(dg_t, dg_j, "dg")
    assert len(dpk_t) == 20
    for i, (a, b) in enumerate(zip(dpk_t, dpk_j)):
        assert tuple(a.shape) == tuple(b.shape), i
        _close(a, b, f"dpacked[{i}]")


def test_k5_plain_matches_field_backward_v6(setup):
    s = setup
    out_j, xacts_j = _jax_fwd(s, True, True)
    packed_j = fp.pack_params_v3f(s["params"])
    d_out = jnp.asarray(s["d_out"]).astype(jnp.bfloat16)
    dg_j, dpk_j = jft.field_backward_v6(packed_j, jnp.asarray(s["g"]),
                                        xacts_j, d_out, out_j, S, tile=TILE,
                                        inner=2, interpret=True)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                      ).to(torch.bfloat16).contiguous()
    dg_t, dpk_t = tft.field_backward_v6(
        _port_packed(s), t(s["g"]), to_t(xacts_j),
        to_t(d_out[:, :tft.OUT_TRAIN]), to_t(out_j[:, :tft.OUT_TRAIN]), S)
    _close(dg_t, dg_j, "dg")
    for i, (a, b) in enumerate(zip(dpk_t, dpk_j)):
        _close(a, b, f"dpacked[{i}]")


_PATCHED = ("field_forward_v6", "field_backward_v5", "field_backward_v6")


@pytest.mark.parametrize("want_dmc", [True, False])
def test_autograd_function_matches_fused_field_train(setup, want_dmc):
    """FusedFieldTrain's parameter, mean_cov and g_bands gradients against
    jax.grad through fused_field_train (normals on, save_acts on), the
    kernels patched to interpret mode."""
    s = setup
    w = s["d_out"]
    saved = {k: getattr(jft, k) for k in _PATCHED}
    for k, fn in saved.items():
        setattr(jft, k, functools.partial(fn, interpret=True))
    try:
        def loss_j(p, m, g):
            out = jft.fused_field_train(p, m, g, S, TILE, True, True,
                                        want_dmc)
            return jnp.sum(out.astype(jnp.float32) * w)

        gp_j, gm_j, gg_j = jax.grad(loss_j, argnums=(0, 1, 2))(
            s["params"], jnp.asarray(s["mc"]), jnp.asarray(s["g"]))
    finally:
        for k, fn in saved.items():
            setattr(jft, k, fn)

    field = port_field(s["tree"])
    field.zero_grad()
    mc = t(s["mc"]).requires_grad_(True)
    dirs_g = t(s["g"]).requires_grad_(True)
    packed = ff.pack_params_v3f_f32(field)
    wd_row = field.field_output_density.net.weight.detach().reshape(1, 256)
    out = tft.fused_field_train(packed, mc, dirs_g, S, True, want_dmc,
                                wd_row)
    (out.float()[:, :tft.OUT_TRAIN] * t(w[:, :tft.OUT_TRAIN])).sum().backward()
    grads = params_to_rsn({k: (p.grad if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in field.named_parameters()})
    ref = jax.tree.map(np.asarray, gp_j)
    for name, layer in grads.items():
        layers = layer if isinstance(layer, list) else [layer]
        refs = ref[name] if isinstance(ref[name], list) else [ref[name]]
        for i, (a, b) in enumerate(zip(layers, refs)):
            for k in ("w", "b"):
                scale = max(float(np.abs(b[k]).max()), 1e-6)
                err = float(np.abs(a[k] - b[k]).max())
                assert err <= 5e-2 * scale, (name, i, k, err, scale)
    _close(dirs_g.grad, gg_j, "g_bands", 5e-2)
    if want_dmc:
        _close(mc.grad, gm_j, "mean_cov", 5e-2)
    else:
        assert float(mc.grad.abs().max()) == 0.0
        assert float(jnp.abs(gm_j).max()) == 0.0
