"""The port's field kernels (K1 field_forward_v3, K2 field_forward_density)
against rsn's Pallas kernels run in interpret mode on the CPU.

Here the wrappers run their plain PyTorch versions (the tensors lie on
the CPU); the CUDA kernels are compared with the same plain versions on
the card by chip_smoke.py.  Outputs are bf16: tolerance atol/rtol 2e-2,
two bf16 ulps near 1, on every live column."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn_torch.kernels import field_forward as ff
from torch_parity import jax_params, n, port_field, rsn_params, t

R, S, TILE = 16, 8, 64
LIVE = list(range(14))


@pytest.fixture(scope="module")
def setup():
    tree = rsn_params(0)
    params, field = jax_params(tree), port_field(tree)
    rng = np.random.default_rng(2)
    N = R * S
    mc = np.zeros((N, 16), np.float32)
    mc[:, 0:3] = rng.uniform(-1.8, 1.8, size=(N, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, size=(N, 3))
    mc[:8, 3:6] = 0.0  # undamped top octaves
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return params, field, mc, dirs


def test_packed_operands_equal_rsn(setup):
    params, field, _, _ = setup
    for name, jpack, tpack in (
            ("v3f", fp.pack_params_v3f(params), ff.pack_params_v3f(field)),
            ("density", fp.pack_params_density(params),
             ff.pack_params_density(field))):
        assert len(jpack) == len(tpack), name
        for i, (a, b) in enumerate(zip(jpack, tpack)):
            want = (torch.bfloat16 if a.dtype == jnp.bfloat16
                    else torch.float32)
            assert b.dtype == want, (name, i)
            a = np.asarray(a.astype(jnp.float32))
            assert tuple(b.shape) == a.shape, (name, i)
            b = n(b)
            if name == "v3f" and i in (16, 17):
                # columns 128: of w_hc / b_hc hold the fp32 fold
                # W_bneck @ W_emb (+ b), whose sums run in another order in
                # each package: b_comb agrees to fp32 rounding, and a bf16
                # rounding of w_comb may land one ulp (2^-8 relative) apart
                np.testing.assert_array_equal(b[:, :128], a[:, :128])
                fold_b, fold_a = b[:, 128:], a[:, 128:]
                if i == 16:
                    np.testing.assert_allclose(fold_b, fold_a, rtol=2 ** -8)
                    assert np.mean(fold_b == fold_a) > 0.99
                else:
                    np.testing.assert_allclose(fold_b, fold_a, rtol=1e-5,
                                               atol=1e-7)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{name}[{i}]")


def test_ipe_matches_rsn_kernel_ipe(setup):
    _, _, mc, _ = setup
    ref = fp._ipe_parts(jnp.asarray(mc), fp.ipe_matrices())[0]
    got = ff.ipe_x(t(mc))
    assert got.dtype == torch.bfloat16 and got.shape == (R * S, 128)
    np.testing.assert_allclose(n(got), np.asarray(ref, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_field_forward_v3_plain_matches_pallas(setup):
    params, field, mc, dirs = setup
    g_j = fp.mid_g_bands(params, jnp.asarray(dirs))
    g_t = ff.mid_g_bands(field, t(dirs))
    np.testing.assert_allclose(n(g_t), np.asarray(g_j), rtol=1e-5, atol=1e-6)
    ref = fp.field_forward_v3(fp.pack_params_v3f(params), jnp.asarray(mc),
                              g_j, S, TILE, interpret=True,
                              out_cols=fp.V3_EVAL_COLS)
    got = ff.field_forward_v3(ff.pack_params_v3f(field), t(mc), g_t, S)
    assert got.dtype == torch.bfloat16 and got.shape == (R * S, 16)
    ref = np.asarray(ref.astype(jnp.float32))
    for c in LIVE:
        np.testing.assert_allclose(n(got)[:, c], ref[:, c], atol=2e-2,
                                   rtol=2e-2, err_msg=f"column {c}")
    assert np.all(n(got)[:, 14:] == 0)


def test_field_forward_density_plain_matches_pallas(setup):
    params, field, mc, _ = setup
    ref = fp.field_forward_density(fp.pack_params_density(params),
                                   jnp.asarray(mc), TILE, interpret=True)
    got = ff.field_forward_density(ff.pack_params_density(field), t(mc))
    assert got.dtype == torch.bfloat16 and got.shape == (R * S, 8)
    np.testing.assert_allclose(n(got), np.asarray(ref.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_density_column_is_bitwise_k1(setup):
    _, field, mc, dirs = setup
    k1 = ff.field_forward_v3(ff.pack_params_v3f(field), t(mc),
                             ff.mid_g_bands(field, t(dirs)), S)
    k2 = ff.field_forward_density(ff.pack_params_density(field), t(mc))
    assert torch.equal(k2[:, 0], k1[:, ff.V3_DENSITY])


def test_cpu_tensors_take_the_plain_version(setup):
    _, field, mc, dirs = setup
    ff.reset_launch_counts()
    packed = ff.pack_params_v3f(field)
    g = ff.mid_g_bands(field, t(dirs))
    out = ff.field_forward_v3(packed, t(mc), g, S)
    assert torch.equal(out, ff.field_forward_v3_plain(packed, t(mc), g, S))
    ff.field_forward_density(ff.pack_params_density(field), t(mc))
    assert {"field_forward_v3", "field_forward_density"} <= set(ff.LAUNCHES)
    assert set(ff.LAUNCHES.values()) == {0}


def test_wrappers_reject_bad_inputs(setup):
    _, field, mc, dirs = setup
    packed = ff.pack_params_v3f(field)
    g = ff.mid_g_bands(field, t(dirs))
    with pytest.raises(ValueError):  # N not a multiple of S
        ff.field_forward_v3(packed, t(mc)[:-1], g, S)
    with pytest.raises(TypeError):   # f64 input
        ff.field_forward_v3(packed, t(mc).double(), g, S)
    with pytest.raises(ValueError):  # non-contiguous
        ff.field_forward_density(ff.pack_params_density(field),
                                 torch.cat([t(mc), t(mc)], 1)[:, ::2])
    with pytest.raises(ValueError):  # wrong operand count
        ff.field_forward_density(packed, t(mc))
    meta = [p.to("meta") for p in ff.pack_params_density(field)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no fallback
        ff.field_forward_density(meta, t(mc).to("meta"))


def test_module_imports_and_runs_without_nvcc(setup, tmp_path):
    """The CPU path needs no nvcc, and a build without one fails with a
    clear error."""
    code = (
        "import torch\n"
        "from rsn_torch.kernels import build, field_forward as ff\n"
        "from rsn_torch.models.field import Field\n"
        "f = Field(torch.Generator().manual_seed(0))\n"
        "mc = torch.zeros(8, 16)\n"
        "ff.field_forward_density(ff.pack_params_density(f), mc)\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert "no nvcc" in res.stdout
