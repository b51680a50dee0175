"""The field API's kernels and the two schedule variants: the plain
versions of K11 (field_forward_v2), K12 (field_forward), the field's kernel
route (Field.get_field_outputs with use_pallas, not differentiable), K10
(field_forward_v5) and K13 (field_backward_v3) against rsn's Pallas
kernels in interpret mode on the CPU, on the same numpy inputs (R=8 rays,
S=8 samples, 32-row tiles on the JAX side; 256 rows for K11 and K12).

K11 and K12 take no `interpret` argument in rsn: their tests patch
`pallas_call` to interpret mode for their own duration.  Outputs are bf16:
atol/rtol 2e-2 (two bf16 ulps near 1), column by column.  The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn.models import field as jfield
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from torch_parity import (assert_grads, jax_params, n, port_field,
                          rsn_params, t)

R, S = 8, 8
N = R * S
TILE = 32
ROWS = 256  # K11 / K12
TOL = 2e-2  # bf16 products, fp32 sums in another order
OUT_COLS = {"bottleneck": ff.OUT_BOTTLENECK,
            "density": slice(ff.OUT_DENSITY, ff.OUT_DENSITY + 1),
            "diff": ff.OUT_DIFF, "tint": ff.OUT_TINT,
            "rough": slice(ff.OUT_ROUGH, ff.OUT_ROUGH + 1),
            "normals": ff.OUT_NORMALS}


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    rng = np.random.default_rng(5)
    mc = np.zeros((ROWS, 16), np.float32)
    mc[:, 0:3] = rng.uniform(-1.8, 1.8, size=(ROWS, 3))
    # the render chunk's covariances span decades: tiny ones leave the top
    # octaves (phases ~8e5) undamped, where a range reduction would show
    mc[:, 3:6] = 10.0 ** rng.uniform(-9.0, -2.0, size=(ROWS, 3))
    mc[:8, 3:6] = 0.0
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jax_params(tree)
    g = fp.mid_g_bands(params, jnp.asarray(dirs))
    d_out = rng.normal(size=(N, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:20] = 0.0  # auxiliary columns: dead by contract
    return dict(tree=tree, params=params, field=port_field(tree), mc=mc,
                g=np.asarray(g), d_out=d_out)


@pytest.fixture
def interpret(monkeypatch):
    """rsn's field_forward_v2 / field_forward in interpret mode."""
    monkeypatch.setattr(fp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _close(got, ref, name, tol=TOL):
    got, ref = n(got), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (name, err, scale)


def test_v2_operands_equal_rsn(setup):
    """pack_params and ipe_matrices hold rsn's values exactly."""
    jpack, tpack = fp.pack_params(setup["params"]), ff.pack_params(
        setup["field"])
    assert len(tpack) == len(jpack) == 18
    for i, (a, b) in enumerate(zip(jpack, tpack)):
        want = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert b.dtype == want, i
        np.testing.assert_array_equal(n(b), np.asarray(a.astype(jnp.float32)))
    for a, b in zip(fp.ipe_matrices(), ff.ipe_matrices()):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(n(b), np.asarray(a))


def _heads_close(got, ref):
    """(N, 384) bf16 outputs, head by head over the OUT_* columns; the
    padding [267, 384) is zero in both."""
    got, ref = n(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (ROWS, ff.OUT_DIM)
    for name, cols in OUT_COLS.items():
        np.testing.assert_allclose(got[:, cols], ref[:, cols], atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert np.all(got[:, ff.N_HEAD_COLS:] == 0)
    assert np.all(ref[:, ff.N_HEAD_COLS:] == 0)


def test_k11_plain_matches_field_forward_v2(setup, interpret):
    s = setup
    ref = fp.field_forward_v2(fp.pack_params(s["params"]),
                              jnp.asarray(s["mc"]), tile=ROWS // 2)
    got = ff.field_forward_v2(ff.pack_params(s["field"]), t(s["mc"]))
    assert got.dtype == torch.bfloat16
    _heads_close(got, ref)


def test_k12_plain_matches_field_forward(setup, interpret):
    """K12 on rsn's own encoding of the rows (_ipe_in_kernel); the port's
    ipe_enc gives the same encoding within one bf16 ulp."""
    s = setup
    enc_j = fp._ipe_in_kernel(jnp.asarray(s["mc"]), *fp.ipe_matrices())
    ref = fp.field_forward(fp.pack_params(s["params"]), enc_j,
                           tile=ROWS // 2)
    enc_t = t(enc_j).to(torch.bfloat16)
    got = ff.field_forward(ff.pack_params(s["field"]), enc_t)
    _heads_close(got, ref)
    ours = n(ff.ipe_enc(t(s["mc"])))
    theirs = np.asarray(enc_j.astype(jnp.float32))
    # one bf16 ulp, and XLA flushes subnormal results (a damping that
    # underflows) to zero where PyTorch keeps them
    ulp = np.maximum(np.maximum(np.abs(ours), np.abs(theirs)) * 2.0 ** -7,
                     np.finfo(np.float32).tiny)
    assert np.all(np.abs(ours - theirs) <= ulp)


def test_kernel_route_matches_rsn(setup, interpret):
    """Field.get_field_outputs(use_pallas=True, differentiable=False)
    against rsn's get_field_outputs on its use_pallas route: all seven
    outputs, on (R, S) batches; the normals as unit vectors."""
    s = setup
    mean = s["mc"][:, 0:3].reshape(32, 8, 3)
    cov = s["mc"][:, 3:6].reshape(32, 8, 3)
    cfg = jfield.FieldConfig(compute_dtype=jnp.bfloat16, use_pallas=True)
    ref = jfield.get_field_outputs(s["params"], jnp.asarray(mean),
                                   jnp.asarray(cov), cfg,
                                   differentiable=False)
    got = s["field"].get_field_outputs(t(mean), t(cov), use_pallas=True,
                                       differentiable=False)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].dtype == (torch.bfloat16 if k == "bottleneck"
                                else torch.float32), k
        np.testing.assert_allclose(n(got[k]), np.asarray(v, np.float32),
                                   atol=TOL, rtol=TOL, err_msg=k)
    norms = np.linalg.norm(n(got["pred_normals"]), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def _port_packed(s, normals=False):
    p = ff.pack_params_v3f(s["field"])
    return tft.pack_params_v4f(p, s["field"]) if normals else p


def _unit(v):
    return -v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


@pytest.mark.parametrize("normals", [False, True])
def test_k10_plain_matches_field_forward_v5(setup, normals):
    """K10's plain version against rsn's pipelined forward (grid 2: the
    prologue and both slot parities) with v3f and v4f packing: columns
    0:24, rsn's 24:128 zero; and it is the plain K7 / train-width K1, bit
    for bit."""
    s = setup
    mc, g = s["mc"][:N], s["g"]
    jpack = (fp.pack_params_v4f(s["params"]) if normals
             else fp.pack_params_v3f(s["params"]))
    ref = np.asarray(fp.field_forward_v5(
        jpack, jnp.asarray(mc), jnp.asarray(g), S, tile=TILE,
        want_normals=normals, interpret=True), np.float32)
    assert np.all(ref[:, tft.OUT_TRAIN:] == 0)
    packed = _port_packed(s, normals)
    got = tft.field_forward_v5(packed, t(mc), t(g), S, normals)
    assert got.shape == (N, tft.OUT_TRAIN) and got.dtype == torch.bfloat16
    for cols in (slice(0, 14), tft.V3_MIDVAL):
        np.testing.assert_allclose(n(got)[:, cols], ref[:, cols], atol=TOL,
                                   rtol=TOL)
    assert np.all(n(got)[:, 20:] == 0)
    if normals:
        dj, dt = ref[:, tft.V4_DPDM], n(got)[:, tft.V4_DPDM]
        live = np.linalg.norm(dj, axis=-1) > 1e-3
        assert live.any()
        cos = np.sum(_unit(dt) * _unit(dj), axis=-1)[live]
        assert cos.min() >= 0.999, cos.min()
    else:
        assert np.all(n(got)[:, tft.V4_DPDM] == 0)
    assert torch.equal(got, tft.field_forward_v4_plain(packed, t(mc), t(g),
                                                       S, normals))


def test_k13_plain_matches_field_backward_v3(setup):
    """K13's plain version against rsn's whole-grid backward, at K8's
    tolerances (dmc's cov columns on their own scale), on the packed
    gradients and through rsn's _unpack_grads (the chain rule through the
    folded bottleneck onto the params tree)."""
    s = setup
    mc, g = s["mc"][:N], s["g"]
    out_j = fp.field_forward_v4(fp.pack_params_v4f(s["params"]),
                                jnp.asarray(mc), jnp.asarray(g), S,
                                tile=TILE, interpret=True)
    d_out = jnp.asarray(s["d_out"]).astype(jnp.bfloat16)
    dmc_j, dg_j, dpk_j = jft.field_backward_v3(
        fp.pack_params_v3f(s["params"]), jnp.asarray(mc), jnp.asarray(g),
        d_out, out_j, S, tile=TILE, interpret=True)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                      ).to(torch.bfloat16).contiguous()
    dmc_t, dg_t, dpk_t = tft.field_backward_v3(
        _port_packed(s), t(mc), t(g), to_t(d_out[:, :tft.OUT_TRAIN]),
        to_t(out_j[:, :tft.OUT_TRAIN]), S)
    _close(dmc_t, dmc_j, "dmc")
    _close(dmc_t[:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    _close(dg_t, dg_j, "dg")
    assert len(dpk_t) == 20
    for i, (a, b) in enumerate(zip(dpk_t, dpk_j)):
        assert tuple(a.shape) == tuple(b.shape), i
        _close(a, b, f"dpacked[{i}]")
    tree = jax.tree.map(np.asarray, s["params"])
    unpack = lambda d: jax.tree.map(np.asarray, jft._unpack_grads(
        tree, tuple(jnp.asarray(np.asarray(x, np.float32)) for x in d)))
    got, ref = unpack([n(a) for a in dpk_t]), unpack(dpk_j)
    ref.pop("low")
    assert_grads(got, ref, TOL)


_WRAPPERS = {
    "field_forward_v2": lambda f, mc: ff.field_forward_v2(
        ff.pack_params(f), mc),
    "field_forward": lambda f, mc: ff.field_forward(
        ff.pack_params(f), ff.ipe_enc(mc)),
    "field_forward_v5": lambda f, mc: tft.field_forward_v5(
        ff.pack_params_v3f(f), mc, torch.zeros(mc.shape[0] // 8, 512,
                                               device=mc.device), 8),
    "field_backward_v3": lambda f, mc: tft.field_backward_v3(
        ff.pack_params_v3f(f), mc,
        torch.zeros(mc.shape[0] // 8, 512, device=mc.device),
        torch.zeros(mc.shape[0], 24, dtype=torch.bfloat16, device=mc.device),
        torch.zeros(mc.shape[0], 24, dtype=torch.bfloat16, device=mc.device),
        8),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_refuse_other_devices_and_count_no_plain_run(setup, name):
    """On the CPU a wrapper runs its plain version and counts no launch;
    on a device that is neither CPU nor CUDA it raises."""
    field, mc = setup["field"], t(setup["mc"][:N])
    ff.reset_launch_counts()
    _WRAPPERS[name](field, mc)
    assert ff.LAUNCHES[name] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        _WRAPPERS[name](copy.deepcopy(field).to("meta"), mc.to("meta"))
