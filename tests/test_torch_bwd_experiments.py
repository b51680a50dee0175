"""The port of rsn's backward experiments (rsn_torch.experiments: K17
bwd_whole, K18 bwd_ablate's four modes, K19 bwd_noipe) against the tools'
functions and rsn's kernels, on the same numpy inputs on the CPU (R=8
rays, S=8 samples; the wrappers run their plain versions on CPU tensors).

None of the three tools runs in rsn as committed: tools/exp_bwd_whole.py
and tools/exp_bwd_noipe.py exit at import, and tools/exp_bwd_ablate.py
unpacks 22 operands from refs[:N_PACKED] although rsn's N_PACKED is now 20
(the folded layout).  So K18 is held against exp_bwd_ablate.py loaded by
path with its N_PACKED patched to 22 (the unfolded count it was written
for) and pl.pallas_call patched to interpret mode, both for each test's
duration (monkeypatch; the tool is not edited): its run(...) (tile=32,
inner=1) for dmc, its pure-JAX _half on the whole rows for dg and the 22
weight gradients.  K19 is held against _half("full") on the x and trunk
activations of rsn's field_forward_v6 spill (interpret mode) and against
rsn's field_backward_v6 (K5, the tool's shipped form); K17 against rsn's
field_backward_v4(n_halves=1), the equivalent exp_bwd_whole.py names.

Tolerances, each of a tensor's max |value|:
  - TOL = 2e-2 (bf16 products with fp32 sums in another order, as K4 / K8
    are held in tests/test_torch_train_kernels.py) for K18 against the
    tool, K19 against _half and K17 against field_backward_v4; dmc's cov
    columns on their own scale.
  - K5_TOL = 5e-2 for K19 against K5 on dg and the trunk's w0..w7, b0..b7:
    the two compute other functions' roundings.  K5 takes diff, tint,
    roughness and mid from the forward's bf16 output where K19 recomputes
    them in fp32, and its folded heads run bf16(dmid_pre) through
    bf16(w_bottleneck @ w_emb) where K19 rounds the bottleneck's cotangent
    to bf16 between the two products; a flipped mid_pre > 0 or a shifted
    attenuation moves a ray's dg.  Measured at these inputs: dg 2.76e-2,
    the trunk's gradients at most 5.1e-3 (w0; PERF.md).
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn_torch.experiments import bwd_ablate, bwd_noipe, bwd_whole
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from torch_parity import jax_params, n, port_field, rsn_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, S = 8, 8
N = R * S
TILE = 32
TOL = 2e-2
K5_TOL = 5e-2


@pytest.fixture(scope="module")
def ablate_tool():
    spec = importlib.util.spec_from_file_location(
        "_tool_exp_bwd_ablate", os.path.join(REPO, "tools",
                                             "exp_bwd_ablate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tool(ablate_tool, monkeypatch):
    """The tool with the unfolded operand count and interpret mode, for the
    test's duration."""
    monkeypatch.setattr(ablate_tool, "N_PACKED", 22)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return ablate_tool


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    rng = np.random.default_rng(3)
    mc = np.zeros((N, 16), np.float32)
    mc[:, :3] = rng.normal(size=(N, 3)) * 0.5
    mc[:, 3:6] = np.abs(rng.normal(size=(N, 3))) * 1e-2
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jax_params(tree)
    g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
    d_out = rng.normal(size=(N, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:] = 0.0  # only columns 0:14 are read
    d_out = np.asarray(jnp.asarray(d_out).astype(jnp.bfloat16), np.float32)
    return dict(params=params, field=port_field(tree), mc=mc, g=g,
                d_out=d_out)


def _bf16(x) -> torch.Tensor:
    return t(np.asarray(x, np.float32)).to(torch.bfloat16).contiguous()


def _close(got, ref, name, tol=TOL):
    got, ref = n(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (name, err, scale)
    return err / scale


def _port(s, mode="full", use_wgrad=True):
    return bwd_ablate.run(mode, use_wgrad, ff.pack_params_v3(s["field"]),
                          t(s["mc"]), t(s["g"]), _bf16(s["d_out"]), S)


def _half(tool, s, mode, x=None):
    """The tool's _half on all N rows -> (dmc, dg (R, 512), contribs)."""
    ipe = tuple(fp.ipe_matrices())
    parts = tool._ipe_parts(jnp.asarray(s["mc"]), ipe)
    if x is not None:
        parts = (x,) + tuple(parts[1:])
    jp = fp.pack_params_v3(s["params"])
    g_rep = jnp.repeat(jnp.asarray(s["g"]), S, axis=0)
    dmc, dg_all, contribs = tool._half(
        mode, parts, g_rep, jnp.asarray(s["d_out"]).astype(jnp.bfloat16),
        ipe, jp[:8], jp[8:16], *jp[16:])
    return dmc, np.asarray(dg_all).reshape(R, S, 512).sum(axis=1), contribs


@pytest.mark.parametrize("mode,use_wgrad", bwd_ablate.VARIANTS)
def test_k18_plain_dmc_matches_the_tools_run(setup, tool, mode, use_wgrad):
    """dmc of each mode against the tool's kernel (its only output)."""
    s = setup
    fn = tool.run(mode, use_wgrad, fp.pack_params_v3(s["params"]),
                  jnp.asarray(s["mc"]), jnp.asarray(s["g"]),
                  jnp.asarray(s["d_out"]).astype(jnp.bfloat16), S, tile=TILE,
                  inner=1)
    ref = np.asarray(fn(jnp.asarray(s["mc"]), jnp.asarray(s["g"]),
                        jnp.asarray(s["d_out"]).astype(jnp.bfloat16)))
    dmc = _port(s, mode, use_wgrad)[0]
    _close(dmc, ref, "dmc")
    if mode == "full":
        _close(dmc[:, 3:6], ref[:, 3:6], "dmc cov")
    if mode == "recompute":
        assert np.all(n(dmc)[:, 1:] == 0) and np.all(ref[:, 1:] == 0)


@pytest.mark.parametrize("mode,use_wgrad", bwd_ablate.VARIANTS)
def test_k18_plain_grads_match_the_tools_half(setup, tool, mode, use_wgrad):
    """dg and, with the weight gradients, all 22 of them against the
    tool's _half; modes without them return None."""
    s = setup
    dmc_j, dg_j, contribs = _half(tool, s, mode)
    dmc, dg, dpk = _port(s, mode, use_wgrad)
    _close(dmc, np.asarray(dmc_j)[:, :16] if mode != "recompute" else
           np.pad(np.asarray(dmc_j), ((0, 0), (0, 15))), "dmc")
    if mode == "recompute":
        assert np.all(n(dg) == 0) and dpk is None
        return
    _close(dg, dg_j, "dg")
    if not use_wgrad:
        assert dpk is None
        return
    assert len(dpk) == 22
    for i, (a, b) in enumerate(zip(dpk, contribs)):
        assert tuple(a.shape) == tuple(ff.V3U_SHAPES[i]) == b.shape, i
        _close(a, b, f"dpacked[{i}]")


@pytest.fixture(scope="module")
def spill(setup):
    """rsn's field_forward_v6 with spill_x on the same rows (interpret
    mode): -> (out (N, 128) bf16, xacts (N, 2176) bf16)."""
    s = setup
    return fp.field_forward_v6(fp.pack_params_v3f(s["params"]),
                               jnp.asarray(s["mc"]), jnp.asarray(s["g"]), S,
                               tile=TILE, interpret=True, spill_x=True)


def _k19(s, xacts):
    return bwd_noipe.run_noipe(ff.pack_params_v3(s["field"]), _bf16(xacts),
                               t(s["g"]), _bf16(s["d_out"]), S)


def test_k19_plain_matches_the_tools_half_on_the_spill(setup, tool, spill):
    """K19 on rsn's spill against _half("full") on the spill's x: dg and
    the 22 weight gradients."""
    s = setup
    xacts = np.asarray(spill[1], np.float32)
    _, dg_j, contribs = _half(tool, s, "full",
                              x=jnp.asarray(spill[1][:, tft.ACTS_COLS:]))
    dg, dpk = _k19(s, xacts)
    _close(dg, dg_j, "dg")
    assert len(dpk) == 22
    for i, (a, b) in enumerate(zip(dpk, contribs)):
        _close(a, b, f"dpacked[{i}]")


def test_k19_plain_matches_field_backward_v6(setup, spill):
    """K19 against rsn's K5 on the same spill: dg and the trunk's
    gradients w0..w7, b0..b7 (K5's heads are folded: no counterpart)."""
    s = setup
    out_j, xacts_j = spill
    dg_j, dpk_j = jft.field_backward_v6(
        fp.pack_params_v3f(s["params"]), jnp.asarray(s["g"]), xacts_j,
        jnp.asarray(s["d_out"]).astype(jnp.bfloat16), out_j, S, tile=TILE,
        inner=2, interpret=True)
    dg, dpk = _k19(s, np.asarray(xacts_j, np.float32))
    _close(dg, dg_j, "dg", K5_TOL)
    for i in range(16):
        _close(dpk[i], dpk_j[i], f"dpacked[{i}]", K5_TOL)


def test_k17_plain_matches_field_backward_v4_whole(setup):
    """K17's plain version against rsn's field_backward_v4(n_halves=1) at
    K8's tolerances (dmc's cov columns on their own scale); it is K8's,
    bit for bit."""
    s = setup
    out_j = fp.field_forward_v4(fp.pack_params_v4f(s["params"]),
                                jnp.asarray(s["mc"]), jnp.asarray(s["g"]),
                                S, tile=TILE, interpret=True)
    d_out = jnp.asarray(s["d_out"]).astype(jnp.bfloat16)
    dmc_j, dg_j, dpk_j = jft.field_backward_v4(
        fp.pack_params_v3f(s["params"]), jnp.asarray(s["mc"]),
        jnp.asarray(s["g"]), d_out, out_j, S, tile=TILE, inner=2,
        interpret=True, n_halves=1)
    packed = ff.pack_params_v3f(s["field"])
    args = (t(s["mc"]), t(s["g"]), _bf16(s["d_out"][:, :tft.OUT_TRAIN]),
            _bf16(np.asarray(out_j[:, :tft.OUT_TRAIN], np.float32)), S)
    dmc, dg, dpk = bwd_whole.field_backward_whole(packed, *args)
    _close(dmc, dmc_j, "dmc")
    _close(dmc[:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    _close(dg, dg_j, "dg")
    assert len(dpk) == 20
    for i, (a, b) in enumerate(zip(dpk, dpk_j)):
        _close(a, b, f"dpacked[{i}]")
    k8 = tft.field_backward_v4(packed, *args)
    assert torch.equal(dmc, k8[0]) and torch.equal(dg, k8[1])
    assert all(torch.equal(a, b) for a, b in zip(dpk, k8[2]))


def test_backward_experiments_raise_on_bad_inputs(setup):
    s = setup
    p3, p1 = ff.pack_params_v3(s["field"]), ff.pack_params_v3f(s["field"])
    mc, g, d_out = t(s["mc"]), t(s["g"]), _bf16(s["d_out"])
    with pytest.raises(ValueError, match="multiple"):
        bwd_ablate.run("full", True, p3, mc[:-1], g, d_out[:-1], S)
    with pytest.raises(ValueError, match="operands"):
        bwd_ablate.run("full", True, p1, mc, g, d_out, S)
    with pytest.raises(ValueError, match="unknown mode"):
        bwd_ablate.run("half", True, p3, mc, g, d_out, S)
    with pytest.raises(ValueError, match="unknown mode"):
        bwd_ablate.run("no_ipe_bwd", True, p3, mc, g, d_out, S)
    xacts = torch.zeros(N, tft.XACTS_COLS, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        bwd_noipe.run_noipe(p3, xacts[:-3], g, d_out[:-3], S)
    with pytest.raises(ValueError, match="operands"):
        bwd_noipe.run_noipe(p3[:21], xacts, g, d_out, S)
    with pytest.raises(ValueError, match="shape"):
        bwd_noipe.run_noipe(p3, xacts[:, :tft.ACTS_COLS].contiguous(), g,
                            d_out, S)
    d24 = d_out[:, :tft.OUT_TRAIN].contiguous()
    with pytest.raises(ValueError, match="multiple"):
        bwd_whole.field_backward_whole(p1, mc[:-1], g, d24[:-1], d24[:-1], S)
    with pytest.raises(ValueError, match="operands"):
        bwd_whole.field_backward_whole(p3, mc, g, d24, d24, S)


def test_k18_k19_plain_take_a_given_bottleneck(setup, spill):
    """The plain K18 (on given activations) and K19 fed a bottleneck: K12's
    plain heads product on the spill's x (what chip_smoke.py feeds them,
    from the card's K12) gives their own results exactly; a bottleneck
    moved by one bf16 ulp where it is live changes dg, so the given one is
    the one used."""
    s = setup
    p3 = ff.pack_params_v3(s["field"])
    xacts = _bf16(spill[1])
    x = xacts[:, tft.ACTS_COLS:].contiguous()
    hs = tft._split_acts(xacts)
    bneck = ff.field_forward(p3[:18], x)[:, ff.OUT_BOTTLENECK]
    args = (p3, hs, x, t(s["g"]), _bf16(s["d_out"]), S, "full", True,
            t(s["mc"]))
    own = bwd_ablate.backward_from_acts(*args)
    fed = bwd_ablate.backward_from_acts(*args, bneck)
    assert all(torch.equal(a, b) for a, b in zip(own[:2], fed[:2]))
    assert all(torch.equal(a, b) for a, b in zip(own[2], fed[2]))
    k19 = bwd_noipe.run_noipe_plain(p3, xacts, t(s["g"]), _bf16(s["d_out"]),
                                    S)
    k19_fed = bwd_noipe.run_noipe_plain(p3, xacts, t(s["g"]),
                                        _bf16(s["d_out"]), S, bneck)
    assert torch.equal(k19[0], k19_fed[0])
    assert all(torch.equal(a, b) for a, b in zip(k19[1], k19_fed[1]))
    nudged = (bneck.float() * (1 + 2.0 ** -7)).to(torch.bfloat16)
    assert not torch.equal(
        bwd_ablate.backward_from_acts(*args, nudged)[1], own[1])
