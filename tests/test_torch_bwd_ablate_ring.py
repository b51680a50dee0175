"""What the card's route of K18's three modes without weight gradients
(full, no_ipe_bwd, recompute; bwd_ablate.ring_backward) relies on, on the
CPU: the forward is recomputed on the Hopper ring and handed to the
backward body through K3's spill layout.  On CPU tensors bwd_ablate.run
runs bwd_ablate_plain in every mode; the spill moves where the
activations wait, not their values, and the card tests hold the route
against its first design bit for bit.

Held here, on numpy inputs made from a seed:
  - kernel F's plain spill (bwd_ablate.spill_plain) against K3's plain
    spill_x (bit for bit) and rsn's field_forward_v6(spill_x=True) in
    interpret mode (TOL = 2e-2 of the max);
  - the unfolded blob's first 32 chunks, which kernel F streams, against
    trunk_sm90.pack_blob's trunk chunks and the train blob's (K3's);
  - the three modes at a ragged shape (R=3 rays, S=7 samples) against
    tools/exp_bwd_ablate.py's pure-JAX _half, within TOL of each tensor's
    max, through tests/test_torch_bwd_experiments.py's `tool` fixture
    (N_PACKED patched to 22); that file holds them at R=8, S=8.
The CUDA kernels are held against their first design bit for bit and
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn_torch.experiments import bwd_ablate
from rsn_torch.experiments.interleave import ring_blob
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels import unfolded_sm90 as us
from test_torch_bwd_experiments import (TILE, TOL, _bf16, _close,  # noqa
                                        ablate_tool, tool)
from torch_parity import jax_params, port_field, rsn_params, t

MODES = ("full", "no_ipe_bwd", "recompute")
RAGGED = (3, 7)
SHAPES = ((8, 8), RAGGED)


@pytest.fixture(scope="module")
def tree():
    return rsn_params(0)


@pytest.fixture(scope="module")
def rows(tree):
    """{(R, S): the rows' numpy inputs and the port's field}."""
    params, field = jax_params(tree), port_field(tree)
    out = {}
    for R, S in SHAPES:
        rng = np.random.default_rng(10 * R + S)
        N = R * S
        mc = np.zeros((N, 16), np.float32)
        mc[:, :3] = rng.normal(size=(N, 3)) * 0.5
        mc[:, 3:6] = np.abs(rng.normal(size=(N, 3))) * 1e-2
        dirs = rng.normal(size=(R, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
        d_out = rng.normal(size=(N, fp.V3_OUT)).astype(np.float32)
        d_out[:, 14:] = 0.0
        d_out = np.asarray(jnp.asarray(d_out).astype(jnp.bfloat16),
                           np.float32)
        out[R, S] = dict(R=R, S=S, params=params, field=field, mc=mc, g=g,
                         d_out=d_out)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_k18_plain_matches_the_tools_half_at_a_ragged_shape(rows, tool,
                                                            mode):
    """dmc and dg of the CPU wrapper against the tool's pure-JAX _half on
    all the rows of R=3 rays of S=7 samples."""
    s = rows[RAGGED]
    R, S = RAGGED
    ipe = tuple(fp.ipe_matrices())
    parts = tool._ipe_parts(jnp.asarray(s["mc"]), ipe)
    jp = fp.pack_params_v3(s["params"])
    g_rep = jnp.repeat(jnp.asarray(s["g"]), S, axis=0)
    dmc_j, dg_all, _ = tool._half(
        mode, parts, g_rep, jnp.asarray(s["d_out"]).astype(jnp.bfloat16),
        ipe, jp[:8], jp[8:16], *jp[16:])
    dmc, dg, dpacked = bwd_ablate.run(
        mode, False, ff.pack_params_v3(s["field"]), t(s["mc"]), t(s["g"]),
        _bf16(s["d_out"]), S)
    assert dpacked is None
    assert dmc.shape == (R * S, 16) and dg.shape == (R, 512)
    dmc_j = np.asarray(dmc_j)
    if mode == "recompute":
        _close(dmc, np.pad(dmc_j, ((0, 0), (0, 15))), "dmc")
        assert torch.all(dmc[:, 1:] == 0) and torch.all(dg == 0)
        return
    _close(dmc, dmc_j[:, :16], "dmc")
    _close(dg, np.asarray(dg_all).reshape(R, S, 512).sum(axis=1), "dg")


def test_kernel_f_plain_spill_is_k3s(rows):
    """Kernel F's plain spill == K3's plain spill_x bit for bit (the same
    IPE and trunk, [hs0..hs7 | x]), and within TOL of rsn's
    field_forward_v6(spill_x=True) in interpret mode."""
    s = rows[8, 8]
    mc = t(s["mc"])
    got = bwd_ablate.spill_plain(ff.pack_params_v3(s["field"]), mc)
    _, k3 = tft.field_forward_v6_plain(ff.pack_params_v3f(s["field"]), mc,
                                       t(s["g"]), s["S"], spill_x=True)
    assert got.dtype == torch.bfloat16
    assert got.shape == (64, tft.XACTS_COLS) and torch.equal(got, k3)
    _, ref = fp.field_forward_v6(fp.pack_params_v3f(s["params"]),
                                 jnp.asarray(s["mc"]), jnp.asarray(s["g"]),
                                 s["S"], tile=TILE, interpret=True,
                                 spill_x=True)
    _close(got, np.asarray(ref, np.float32), "spill")


def test_unfolded_blob_starts_with_the_trunk_chunks(rows):
    """Kernel F streams the unfolded blob's first 32 chunks: they are
    trunk_sm90.pack_blob's trunk chunks of the same weights, and the train
    blob's (K3's) first 32 chunks."""
    field = rows[8, 8]["field"]
    p3 = ff.pack_params_v3(field)
    blob = ring_blob(p3)
    trunk_elems = us.TRUNK_CHUNKS * ts.CHUNK_K * ff.TRUNK_WIDTH
    assert us.TRUNK_CHUNKS == 32 and trunk_elems == 32 * 64 * 256
    trunk = ts.pack_blob(p3[:8])
    assert trunk.numel() == trunk_elems
    assert torch.equal(blob[:trunk_elems], trunk)
    p1 = ff.pack_params_v3f(field)
    train = ts.pack_train_blob(p1[:8], p1[16])
    assert torch.equal(train[:trunk_elems], trunk)
    assert ring_blob(p3) is blob  # packed once per operand tuple
