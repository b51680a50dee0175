"""K18's full + wgrad mode and K19 in two phases, on the CPU: the UNFOLDED
record layout of rsn_torch/kernels/wgrad_sm90.py (the workspace that their
kernel A, experiments_bwd.cu, stashes each 64-row tile's weight-gradient
operands into, and kernel B, wgrad_sm90.cuh, contracts) and the plain
version of the two phases (rsn_torch.experiments.bwd_ablate
.bwd_ablate_chunked_plain, bwd_noipe.run_noipe_chunked_plain).

The records round-trip exactly, zero rows included; the layout's
constants and its 22 output tiles are the CUDA sources'; the chunks walk
K4's partition; the two phases give the one-phase plain version's dmc,
dg, biases, w_out and b_out bit for bit and its weight matrices within
W_TOL of each max (the same fp32 products summed in another order, by
record, slice and chunk), and K19's equal K18's on K3's spill bit for bit;
and they agree with the tool they port, tools/exp_bwd_ablate.py loaded by
path as tests/test_torch_bwd_experiments.py loads it (its N_PACKED patched
to 22, pallas_call to interpret mode; the tool is not edited): K18 with
its _half, the body of its run's kernel (dmc, dg, the 22 gradients), K19
with _half("full") on rsn's spill (tools/exp_bwd_noipe.py exits at
import), within TOL of each max.  The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from rsn.kernels import field_pallas as fp
from rsn_torch.experiments import bwd_ablate, bwd_noipe
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.models.field import Field
from torch_parity import jax_params, n, port_field, rsn_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "rsn_torch", "csrc")
W_TOL = 1e-5  # weight matrices: the same fp32 products in another order
TOL = 2e-2    # against the tool: bf16 products, fp32 sums in another order
              # (tests/test_torch_bwd_experiments.py)
EXACT = list(range(8, 16)) + [17, 19, 20, 21]  # b0..b7, bh, b_mid, w_out,
                                               # b_out
WEIGHTS = list(range(8)) + [16, 18]            # w0..w7, wh, w_emb


def _operands(rng, nv):
    """An unfolded tile's operands with rows nv.. zero, as kernel A stores
    them."""
    def tile(cols):
        a = rng.standard_normal((wg.REC_ROWS, cols)).astype(np.float32)
        a[nv:] = 0.0
        return torch.from_numpy(a).to(torch.bfloat16)
    return (tile(128), [tile(256) for _ in range(8)],
            [tile(256) for _ in range(8)], tile(wg.DHEADS_N), tile(256),
            tile(128))


@pytest.mark.parametrize("nv", [64, 7, 0])
def test_unfolded_record_round_trips(nv):
    """unpack_unfolded(pack_unfolded(...)) gives back every operand bit for
    bit; rows past nv stay zero; a record is 9,760 bytes per row, its first
    17 operands where K8's are, and each operand is feature-major with
    16-byte group g of feature f at position g ^ (f % 8)."""
    x, hs, dpre, dh, bn, dm = _operands(np.random.default_rng(nv), nv)
    rec = wg.pack_unfolded(x, hs, dpre, dh, bn, dm)
    assert rec.dtype == torch.bfloat16 and rec.numel() == wg.U_REC_ELEMS
    assert wg.U_REC_BYTES == 9760 * 64
    got = wg.unpack_unfolded(rec)
    assert torch.equal(got[0], x)
    assert all(torch.equal(a, b) for a, b in zip(got[1] + got[2],
                                                 hs + dpre))
    assert all(torch.equal(a, b) for a, b in zip(got[3:], (dh, bn, dm)))
    assert torch.equal(rec[:wg.DHC_OFF],
                       wg.pack_record(x, hs, dpre,
                                      torch.zeros(64, wg.HEAD_N))[:wg.DHC_OFF])
    for off, a, f, r in ((wg.U_DHEADS_OFF, dh, 261, 5),
                         (wg.U_COT_OFF, dh[:, 256:], 3, 60),
                         (wg.U_BNECK_OFF, bn, 100, 33),
                         (wg.U_DMID_OFF, dm, 127, 6)):
        assert rec[off + f * 64 + ((r // 8) ^ (f % 8)) * 8 + r % 8] == a[r, f]
    if nv == 0:
        assert not torch.any(rec != 0)


def test_unfolded_layout_matches_the_kernels():
    """The 22 output tiles cover every float of the partial once, each from
    the right operands; the record, partial, tile, compact-slice, chunk and
    shared-memory sizes are the CUDA sources' constants; the first 16 tiles
    are K8's."""
    covered = np.zeros(wg.U_PARTIAL_FLOATS, np.int32)
    for layer, fb, a_off, b_off, n_, out in wg.U_OUT_TILES:
        covered[out:out + wg.TILE_FEATS * n_] += 1
        if layer < 8:
            assert b_off == wg.DPRE_OFF + layer * 256 * 64 and n_ == 256
        hs7 = wg.ACT_OFF + 7 * 256 * 64 + fb * 128 * 64
        want = {8: (hs7, wg.U_DHEADS_OFF, 256), 9: (hs7, wg.U_COT_OFF, 16),
                10: (wg.U_BNECK_OFF + fb * 128 * 64, wg.U_DMID_OFF, 128)}
        if layer >= 8:
            assert (a_off, b_off, n_) == want[layer]
    assert np.all(covered == 1) and len(wg.U_OUT_TILES) == 22
    assert wg.U_OUT_TILES[:16] == wg.OUT_TILES[:16]
    assert wg.U_PARTIAL_FLOATS == 524288 + 256 * 272 + 256 * 128
    hdr = open(os.path.join(CSRC, "wgrad_sm90.cuh")).read()
    assert f"static_assert(UNF_REC_BYTES == {wg.U_REC_BYTES}" in hdr
    assert re.search(r"constexpr int UNF_OUT_TILES = 22;", hdr)
    assert f"static_assert(UNF_PARTIAL_FLOATS == {wg.U_PARTIAL_FLOATS}" in hdr
    src = open(os.path.join(CSRC, "experiments_bwd.cu")).read()
    assert (f"USlice<true>::FLOATS == {bwd_ablate.SMALL_FLOATS}" in src
            and bwd_ablate.SMALL_FLOATS == wg.UNFOLDED.small_floats == 2948)
    assert wg.FOLDED.small_floats == tft.SMALL_FLOATS
    assert "static_assert(TILES_PER_CHUNK == 4" in src
    assert wg.UNFOLDED.tiles_per_chunk == 4
    assert re.search(r"SMEM_STASH == 205824 &&\s+SMEM_STASH <= 232448", src)
    for name in ("rsn_bwd_ablate_stash", "rsn_bwd_noipe_stash",
                 wg.UNFOLDED.entry):
        assert f"int {name}(" in src
    assert wg.slices_for(132, 512, wg.UNFOLDED) == 6


@pytest.mark.parametrize("R,S,sms", [(1024, 128, 132), (3, 200, 1)])
def test_unfolded_chunks_walk_k4_partition(R, S, sms):
    """K18's and K19's plans are K8's partition with the UNFOLDED layout's
    chunks and slices; at the tools' rows (1,024 rays x 128 samples on 132
    SMs) 4 chunks of 128 blocks x 4 tiles, P = 6, and K18's scratch is
    374,114,304 bytes (the first design's slices and slots: 378,863,616)."""
    plan = bwd_ablate.stash_plan(R, S, sms)
    k8 = tft.stash_plan(R, S, sms)
    assert (plan.rays_per_block, plan.blocks, plan.tiles, plan.chunks) == (
        k8.rays_per_block, k8.blocks, k8.tiles, k8.chunks)
    assert plan.layout == wg.UNFOLDED
    assert plan.slices == wg.slices_for(
        sms, plan.blocks * (plan.chunks[0][1] - plan.chunks[0][0]),
        wg.UNFOLDED)
    if (R, S) == (1024, 128):
        assert plan.chunks == ((0, 4), (4, 8), (8, 12), (12, 16))
        assert plan.slices == 6
        assert bwd_ablate.scratch_bytes(plan) == 374114304
        assert bwd_ablate.scratch_bytes(
            bwd_ablate.stash_plan(R, S, sms, recompute=False)) == 336365568
    else:
        assert len(plan.chunks) == 3 and plan.slices == 1


def _inputs(R, S, seed):
    field = Field(torch.Generator().manual_seed(seed)).eval()
    rng = np.random.default_rng(seed)
    mc = np.zeros((R * S, 16), np.float32)
    mc[:, :3] = rng.uniform(-1.5, 1.5, (R * S, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, (R * S, 3))
    mc = torch.from_numpy(mc)
    dirs = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(R, 3)).astype(np.float32)), dim=-1)
    g = ff.mid_g_bands(field, dirs)
    d_out = rng.normal(size=(R * S, bwd_ablate.D_OUT_COLS)).astype(
        np.float32)
    d_out[:, 14:] = 0.0
    return (field, mc, g, torch.from_numpy(d_out).to(torch.bfloat16))


@pytest.mark.parametrize("kernel", ["K18", "K19"])
@pytest.mark.parametrize("R,S,sms", [(8, 8, 132), (3, 7, 132), (1, 1, 132),
                                     (3, 200, 1)])
def test_two_phases_match_plain(R, S, sms, kernel):
    """The plain two-phase K18 full + wgrad or K19 on the card's schedule
    (one chunk; ragged tiles; one row; three chunks) equals its plain
    version on dmc, dg, the biases, w_out and b_out, bit for bit, and on
    w0..w7, wh and w_emb within W_TOL of each tensor's max; K19's two
    phases on K3's spill equal K18's (dg, the 22 gradients) bit for bit
    (the card's identity: one schedule, the same operands)."""
    field, mc, g, d_out = _inputs(R, S, R + S)
    p3 = ff.pack_params_v3(field)
    k18 = bwd_ablate.bwd_ablate_chunked_plain(p3, mc, g, d_out, S, sms)
    if kernel == "K18":
        ref = bwd_ablate.bwd_ablate_plain(p3, mc, g, d_out, S)
        got = k18
        assert torch.equal(got[0], ref[0])
    else:
        _, xacts = tft.field_forward_v6(ff.pack_params_v3f(field), mc, g, S,
                                        spill_x=True)
        ref = (None,) + bwd_noipe.run_noipe_plain(p3, xacts, g, d_out, S)
        got = (None,) + bwd_noipe.run_noipe_chunked_plain(p3, xacts, g,
                                                          d_out, S, sms)
        assert torch.equal(got[1], k18[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], k18[2]))
    assert torch.equal(got[1], ref[1])
    assert len(got[2]) == 22
    for i, (a, b) in enumerate(zip(got[2], ref[2])):
        assert tuple(a.shape) == tuple(ff.V3U_SHAPES[i]) == tuple(b.shape)
        if i in EXACT:
            assert torch.equal(a, b), i
        else:
            assert i in WEIGHTS
            assert float((a - b).abs().max()) <= W_TOL * float(
                b.abs().max()), i
    assert len(bwd_ablate.stash_plan(R, S, sms).chunks) == (
        3 if (R, S) == (3, 200) else 1)


@pytest.mark.parametrize("records,slices", [(1, 1), (5, 3)])
def test_unfolded_contraction_by_slices(records, slices):
    """Plain kernel B on seeded UNFOLDED records: the P partials sum to A^T
    B over all rows within W_TOL, whatever P, and unfolded_weight_grads
    puts wh's 272 columns and w_emb in their operands' shapes; on CPU
    tensors the wrapper runs the plain version and counts no launch."""
    rng = np.random.default_rng(records)
    ws = torch.from_numpy(rng.standard_normal(
        (records, wg.U_REC_ELEMS)).astype(np.float32)).to(torch.bfloat16)
    recs = [wg.unpack_unfolded(ws[r]) for r in range(records)]
    cat = lambda k: torch.cat([r[k] for r in recs]).double()
    hs7 = torch.cat([r[1][7] for r in recs]).double()
    want_wh = hs7.t() @ cat(3)
    want_emb = cat(4).t() @ cat(5)
    ff.reset_launch_counts()
    partial = torch.full((slices, wg.U_PARTIAL_FLOATS), float("nan"))
    wg.contract(ws, partial, False, wg.UNFOLDED)
    assert ff.LAUNCHES[wg.UNFOLDED.label] == 0
    got = wg.unfolded_weight_grads(partial)
    assert len(got) == 10 and got[8].shape == (256, 384)
    assert torch.all(got[8][:, wg.DHEADS_N:] == 0)
    for a, b in ((got[8][:, :wg.DHEADS_N], want_wh), (got[9], want_emb)):
        assert float((a.double() - b).abs().max()) <= W_TOL * float(
            b.abs().max())
    w3 = torch.cat([r[1][2] for r in recs]).double().t() @ torch.cat(
        [r[2][3] for r in recs]).double()
    assert float((got[3].double() - w3).abs().max()) <= W_TOL * float(
        w3.abs().max())


# ---- against the tool (rsn, interpret mode) ---------------------------------

R0, S0 = 8, 8


@pytest.fixture(scope="module")
def ablate_tool():
    spec = importlib.util.spec_from_file_location(
        "_tool_exp_bwd_ablate_sm90",
        os.path.join(REPO, "tools", "exp_bwd_ablate.py"))
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
    rng = np.random.default_rng(5)
    N = R0 * S0
    mc = np.zeros((N, 16), np.float32)
    mc[:, :3] = rng.normal(size=(N, 3)) * 0.5
    mc[:, 3:6] = np.abs(rng.normal(size=(N, 3))) * 1e-2
    dirs = rng.normal(size=(R0, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    params = jax_params(tree)
    g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
    d_out = rng.normal(size=(N, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:] = 0.0
    d_out = np.asarray(jnp.asarray(d_out).astype(jnp.bfloat16), np.float32)
    return dict(params=params, field=port_field(tree), mc=mc, g=g,
                d_out=d_out)


def _close(got, ref, name):
    got, ref = n(got), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    assert float(np.abs(got - ref).max()) <= TOL * scale, name


def _bf16(x) -> torch.Tensor:
    return t(np.asarray(x, np.float32)).to(torch.bfloat16).contiguous()


@pytest.mark.parametrize("kernel", ["K18", "K19"])
def test_two_phases_match_the_tool(setup, tool, kernel):
    """K18's two phases against the tool's _half, the body of its run's
    kernel (dmc, its cov columns on their own scale, dg, the 22
    gradients); K19's on rsn's spill (interpret mode) against
    _half("full") on the spill's x; TOL of each tensor's max; both over
    two slices (sms = 2).  (run itself, 8 s in interpret mode, holds the
    one-phase plain's dmc in tests/test_torch_bwd_experiments.py; the two
    phases' dmc is that one bit for bit, test_two_phases_match_plain.)"""
    s = setup
    p3 = ff.pack_params_v3(s["field"])
    jp = fp.pack_params_v3(s["params"])
    d_j = jnp.asarray(s["d_out"]).astype(jnp.bfloat16)
    ipe = tuple(fp.ipe_matrices())
    parts = tool._ipe_parts(jnp.asarray(s["mc"]), ipe)
    if kernel == "K18":
        got = bwd_ablate.bwd_ablate_chunked_plain(
            p3, t(s["mc"]), t(s["g"]), _bf16(s["d_out"]), S0, 2)
    else:
        _, xacts = fp.field_forward_v6(fp.pack_params_v3f(s["params"]),
                                       jnp.asarray(s["mc"]),
                                       jnp.asarray(s["g"]), S0, tile=32,
                                       interpret=True, spill_x=True)
        got = (None,) + bwd_noipe.run_noipe_chunked_plain(
            p3, _bf16(xacts), t(s["g"]), _bf16(s["d_out"]), S0, 2)
        parts = (xacts[:, tft.ACTS_COLS:],) + tuple(parts[1:])
    g_rep = jnp.repeat(jnp.asarray(s["g"]), S0, axis=0)
    dmc_j, dg_all, contribs = tool._half("full", parts, g_rep, d_j, ipe,
                                         jp[:8], jp[8:16], *jp[16:])
    if kernel == "K18":
        _close(got[0], np.asarray(dmc_j)[:, :16], "dmc")
        _close(got[0][:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    _close(got[1], np.asarray(dg_all).reshape(R0, S0, 512).sum(axis=1),
           "dg")
    assert len(got[2]) == 22
    for i, (a, b) in enumerate(zip(got[2], contribs)):
        _close(a, b, f"dpacked[{i}]")
