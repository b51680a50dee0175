"""The port of rsn's forward experiments (rsn_torch.experiments: K14 v3u /
v3i, K15 v3L / v3F, K16's eight modes) against the tools' own functions,
on the same numpy inputs on the CPU.

The tools (tools/exp_interleave.py, tools/exp_interleave2.py,
tools/exp_cheap_sin.py) are loaded by path (tools/ is no package) and run
with `pallas_call` patched to interpret mode for each test's duration.
K14 / K15: R=8 rays, S=8 samples, 32-row tiles on the JAX side, the wide
covariances of tests/test_torch_field_api_kernels.py (undamped top
octaves); bf16 outputs, column by column within 2e-2 of each column's max
|value| (two bf16 ulps), columns 14:128 zero on both sides.  K16 on
(256, 128) of the tool's input: copy bit for bit, the fp32 modes within
1e-6 (XLA contracts some products into fma, PyTorch does not), poly_bf16
within one bf16 ulp.  The CUDA kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from rsn.kernels import field_pallas as fp
from rsn_torch.experiments import cheap_sin, interleave, interleave2
from rsn_torch.kernels import field_forward as ff
from torch_parity import jax_params, n, port_field, rsn_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, S = 8, 8
N = R * S
TILE = 32
TOL = 2e-2


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {k: _tool(k) for k in ("exp_interleave", "exp_interleave2",
                                  "exp_cheap_sin")}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    rng = np.random.default_rng(5)
    mc = np.zeros((N, 16), np.float32)
    mc[:, 0:3] = rng.uniform(-1.8, 1.8, size=(N, 3))
    mc[:, 3:6] = 10.0 ** rng.uniform(-9.0, -2.0, size=(N, 3))
    mc[:8, 3:6] = 0.0
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jax_params(tree)
    g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
    return dict(params=params, field=port_field(tree), mc=mc, g=g)


def test_pack_params_v3_equals_rsn(setup):
    jpack = fp.pack_params_v3(setup["params"])
    tpack = ff.pack_params_v3(setup["field"])
    assert len(tpack) == len(jpack) == 22
    for i, (a, b) in enumerate(zip(jpack, tpack)):
        want = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
        assert b.dtype == want and tuple(b.shape) == a.shape, i
        np.testing.assert_array_equal(n(b), np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("variant", ["v3u", "v3i", "v3L", "v3F"])
def test_forward_plain_matches_the_tool(setup, tools, interpret, variant):
    s = setup
    jpack = fp.pack_params_v3(s["params"])
    mc, g = jnp.asarray(s["mc"]), jnp.asarray(s["g"])
    tpack = ff.pack_params_v3(s["field"])
    if variant in ("v3u", "v3i"):
        ref = getattr(tools["exp_interleave"], f"field_forward_{variant}")(
            jpack, mc, g, S, TILE)
        got = getattr(interleave, f"field_forward_{variant}")(
            tpack, t(s["mc"]), t(s["g"]), S)
    else:
        full = variant == "v3F"
        ref = tools["exp_interleave2"].field_forward_v3L(jpack, mc, g, S,
                                                         TILE, full)
        got = interleave2.field_forward_v3L(tpack, t(s["mc"]), t(s["g"]), S,
                                            full)
    got, ref = n(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (N, 128)
    for c in range(14):
        scale = max(float(np.abs(ref[:, c]).max()), 1e-6)
        err = float(np.abs(got[:, c] - ref[:, c]).max())
        assert err <= TOL * scale, (c, err, scale)
    assert np.all(got[:, 14:] == 0) and np.all(ref[:, 14:] == 0)


@pytest.mark.parametrize("mode", cheap_sin.MODES)
def test_cheap_sin_plain_matches_the_tool(tools, interpret, mode):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(256, 128))
         * np.exp2(np.arange(128) % 16)).astype(np.float32)
    ref = np.asarray(tools["exp_cheap_sin"].run(mode, jnp.asarray(x), 128)(
        jnp.asarray(x)), np.float32)
    got = n(cheap_sin.run(mode, t(x)))
    assert got.shape == ref.shape == (256, 128)
    if mode == "copy":
        np.testing.assert_array_equal(got, ref)
    elif mode == "poly_bf16":
        assert np.all(np.abs(got - ref) <= n(cheap_sin.bf16_ulp(t(ref))))
    else:
        assert float(np.abs(got - ref).max()) <= 1e-6, mode


def test_experiments_raise_on_bad_inputs(setup):
    tpack = ff.pack_params_v3(setup["field"])
    mc, g = t(setup["mc"]), t(setup["g"])
    with pytest.raises(ValueError, match="multiple"):
        interleave.field_forward_v3u(tpack, mc[:-1], g, S)
    with pytest.raises(ValueError, match="operands"):
        interleave2.field_forward_v3L(tpack[:20], mc, g, S)
    with pytest.raises(ValueError, match="unknown mode"):
        cheap_sin.run("tan", mc)
    with pytest.raises(ValueError, match="shape"):
        cheap_sin.run("copy", mc)
