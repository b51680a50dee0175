"""K8's redesign on the CPU (rsn_torch/kernels/wgrad_sm90.py and K8's
schedule in rsn_torch/kernels/field_train.py): the workspace records
round-trip exactly, zero rows included; the 18 output tiles and the
layout constants are the ones rsn_torch/csrc/wgrad_sm90.cuh and
field_train.cu use; K8's chunks walk K4's partition; and the plain
version of K8's two phases (kernel A's stash, kernel B's contraction by
slices, the partials summed) gives field_backward_v4_plain's dmc, dg,
biases and mid-head gradients exactly and its weight matrices within
1e-5 of each max, and agrees with rsn's field_backward_v4 in interpret
mode.  The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.models.field import Field
from torch_parity import jax_params, n, port_field, rsn_params, t

CSRC = os.path.join(os.path.dirname(wg.__file__), "..", "csrc")
W_TOL = 1e-5   # weight matrices: the same fp32 products summed in another
               # order (by record, slice and chunk)
RSN_TOL = 2e-2  # tests/test_torch_train_kernels.py: bf16 products, fp32
                # sums in another order


def _operands(rng, nv):
    """A tile's operands with rows nv.. zero, as kernel A stores them."""
    def tile(cols):
        a = rng.standard_normal((wg.REC_ROWS, cols)).astype(np.float32)
        a[nv:] = 0.0
        return torch.from_numpy(a).to(torch.bfloat16)
    return (tile(128), [tile(256) for _ in range(8)],
            [tile(256) for _ in range(8)], tile(wg.HEAD_N))


@pytest.mark.parametrize("nv", [64, 7, 0])
def test_record_round_trips(nv):
    """unpack_record(pack_record(...)) gives back every operand bit for
    bit; rows past nv stay zero; a record is 8,736 bytes per row and each
    operand is feature-major with 16-byte group g of feature f at position
    g ^ (f % 8)."""
    x, hs, dpre, dhc = _operands(np.random.default_rng(nv), nv)
    rec = wg.pack_record(x, hs, dpre, dhc)
    assert rec.dtype == torch.bfloat16 and rec.numel() == wg.REC_ELEMS
    assert wg.REC_BYTES == 8736 * 64
    gx, ghs, gdpre, gdhc = wg.unpack_record(rec)
    assert torch.equal(gx, x) and torch.equal(gdhc, dhc)
    assert all(torch.equal(a, b) for a, b in zip(ghs + gdpre, hs + dpre))
    for f, r in ((0, 0), (5, 13), (127, 63), (64, 40)):
        pos = wg.X_OFF + f * 64 + ((r // 8) ^ (f % 8)) * 8 + r % 8
        assert rec[pos] == x[r, f]
    for f, r in ((3, 9), (200, 62)):
        pos = (wg.DPRE_OFF + 5 * 256 * 64 + f * 64 + ((r // 8) ^ (f % 8)) * 8
               + r % 8)
        assert rec[pos] == dpre[5][r, f]
    if nv == 0:
        assert not torch.any(rec != 0)


def test_layout_matches_the_kernels():
    """The 18 output tiles cover every row of w0..w7 and w_hc's 144
    columns once, each from the right operand; the record, partial, tile
    and compact-slice sizes are the CUDA sources' constants."""
    covered = np.zeros(wg.PARTIAL_FLOATS, np.int32)
    for layer, fb, a_off, b_off, n_, out in wg.OUT_TILES:
        covered[out:out + wg.TILE_FEATS * n_] += 1
        if layer < 8:
            assert b_off == wg.DPRE_OFF + layer * 256 * 64 and n_ == 256
        else:
            assert b_off == wg.DHC_OFF and n_ == wg.HEAD_N
        feats = layer == 0 or (layer == 4 and fb == 0)
        assert (a_off == wg.X_OFF) == feats
    assert np.all(covered == 1) and len(wg.OUT_TILES) == 18
    assert wg.PARTIAL_FLOATS == 524288 + 256 * 144
    src = open(os.path.join(CSRC, "wgrad_sm90.cuh")).read()
    assert "static_assert(REC_BYTES == 559104" in src
    assert re.search(r"constexpr int OUT_TILES = 18;", src)
    assert re.search(r"constexpr int TILE_FEATS = 128;", src)
    train = open(os.path.join(CSRC, "field_train.cu")).read()
    assert f"GradSlice<true>::FLOATS == {tft.SMALL_FLOATS}" in train
    assert tft.TILES_PER_CHUNK == 4 and tft.SMALL_FLOATS == 2692


@pytest.mark.parametrize("R,S,sms", [(8, 8, 132), (3, 7, 132), (1, 1, 132),
                                     (1024, 128, 132), (512, 64, 132),
                                     (1000, 64, 132), (3, 200, 1),
                                     (40, 200, 36)])
def test_chunks_walk_k4_partition(R, S, sms):
    """Every chunk's records, in workspace order, are K4's tiles (whole
    rays per block, ceil(R / sms) rays per block, 64-row tiles from each
    run's first row): each tile once, in the order its block walks it;
    records past a run's end have no rows; chunks of 4 tiles."""
    plan = tft.k8_plan(R, S, sms)
    rpb = max(1, -(-R // sms))
    assert plan.rays_per_block == rpb and plan.blocks == -(-R // rpb)
    want = {}
    for b in range(plan.blocks):
        row_a, row_b = b * rpb * S, min(R, (b + 1) * rpb) * S
        want[b] = [(r, min(64, row_b - r)) for r in range(row_a, row_b, 64)]
    got = {b: [] for b in range(plan.blocks)}
    for c, (t0, t1) in enumerate(plan.chunks):
        assert t1 - t0 <= tft.TILES_PER_CHUNK
        assert t0 == (plan.chunks[c - 1][1] if c else 0)
        recs = plan.records((t0, t1))
        assert len(recs) == plan.blocks * (t1 - t0)
        for i, (b, tile, row0, nv) in enumerate(recs):
            assert i == b * (t1 - t0) + tile - t0
            if nv:
                got[b].append((row0, nv))
    assert plan.chunks[-1][1] == plan.tiles
    assert got == want
    if (R, S) == (1024, 128):  # the camera-on step's pass 2
        assert plan.chunks == ((0, 4), (4, 8), (8, 12), (12, 16))
        assert plan.slices == 7 and plan.scratch_bytes() == 336906240


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
    packed = ff.pack_params_v3f(field)
    out = tft.field_forward_v3_train(packed, mc, g, S)
    d_out = rng.normal(size=(R * S, tft.OUT_TRAIN)).astype(np.float32)
    d_out[:, 14:] = 0.0
    return packed, mc, g, torch.from_numpy(d_out).to(torch.bfloat16), out


EXACT = list(range(8, 16)) + [17, 18, 19]   # b0..b7, b_hc, w_out, b_out
WEIGHTS = list(range(8)) + [16]             # w0..w7, w_hc


@pytest.mark.parametrize("R,S,sms", [(8, 8, 132), (3, 7, 132), (3, 200, 1),
                                     (40, 200, 36)])
def test_two_phases_match_plain(R, S, sms):
    """The plain two-phase K8 on the card's schedule (one chunk; ragged
    tiles; three chunks; two chunks over two slices) equals the plain K8
    on dmc, dg, the biases, w_out and b_out, bit for bit, and on w0..w7
    and w_hc within W_TOL of each tensor's max."""
    args = _inputs(R, S, R + S)
    plan = tft.k8_plan(R, S, sms)
    ref = tft.field_backward_v4_plain(*args, S)
    got = tft.field_backward_v4_chunked_plain(*args, S, sms)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert len(got[2]) == 20
    for i in EXACT:
        assert torch.equal(got[2][i], ref[2][i]), i
    for i in WEIGHTS:
        a, b = got[2][i], ref[2][i]
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= W_TOL * float(b.abs().max()), i
    assert len(plan.chunks) >= (3 if (R, S) == (3, 200) else 1)


def test_two_phases_match_rsn_field_backward_v4():
    """The plain two-phase K8 against rsn's recompute backward in interpret
    mode (R = 8, S = 8, 32-row tiles on the JAX side), at
    tests/test_torch_train_kernels.py's tolerance of each tensor's max."""
    R, S = 8, 8
    tree = rsn_params(0)
    params, field = jax_params(tree), port_field(tree)
    rng = np.random.default_rng(1)
    mc = np.zeros((R * S, 16), np.float32)
    mc[:, :3] = rng.normal(size=(R * S, 3)).astype(np.float32) * 0.5
    mc[:, 3:6] = np.abs(rng.normal(size=(R * S, 3))).astype(np.float32) * 1e-2
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
    d_out = rng.normal(size=(R * S, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:20] = 0.0
    out_j = fp.field_forward_v4(fp.pack_params_v4f(params), jnp.asarray(mc),
                                jnp.asarray(g), S, tile=32, interpret=True)
    dj = jnp.asarray(d_out).astype(jnp.bfloat16)
    dmc_j, dg_j, dpk_j = jft.field_backward_v4(
        fp.pack_params_v3f(params), jnp.asarray(mc), jnp.asarray(g), dj,
        out_j, S, tile=32, inner=2, interpret=True)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                      ).to(torch.bfloat16).contiguous()
    got = tft.field_backward_v4_chunked_plain(
        ff.pack_params_v3f(field), t(mc), t(g),
        to_t(dj[:, :tft.OUT_TRAIN]), to_t(out_j[:, :tft.OUT_TRAIN]), S, 2)

    def close(a, b, name):
        b = np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-6)
        assert float(np.abs(n(a) - b).max()) <= RSN_TOL * scale, name

    close(got[0], dmc_j, "dmc")
    close(got[0][:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    close(got[1], dg_j, "dg")
    for i, (a, b) in enumerate(zip(got[2], dpk_j)):
        assert tuple(a.shape) == tuple(b.shape), i
        close(a, b, f"dpacked[{i}]")


@pytest.mark.parametrize("records,slices", [(1, 1), (5, 3), (9, 7)])
def test_contraction_by_slices(records, slices):
    """Plain kernel B on seeded records: the P partials sum to A^T B over
    all rows within W_TOL, whatever P; a second call with accumulate adds
    to the partials; on CPU tensors the wrapper runs the plain version and
    counts no launch."""
    rng = np.random.default_rng(records)
    ws = torch.from_numpy(rng.standard_normal(
        (records, wg.REC_ELEMS)).astype(np.float32)).to(torch.bfloat16)
    ref = torch.zeros(wg.PARTIAL_FLOATS)
    for _, _, a_off, b_off, n_, out in wg.OUT_TILES:
        a = torch.cat([wg._unswizzle(ws[r, a_off:a_off + 128 * 64], 128)
                       for r in range(records)])
        b = torch.cat([wg._unswizzle(ws[r, b_off:b_off + n_ * 64], n_)
                       for r in range(records)])
        ref[out:out + 128 * n_] = (a.double().t() @ b.double()).float() \
            .reshape(-1)
    ff.reset_launch_counts()
    partial = torch.full((slices, wg.PARTIAL_FLOATS), float("nan"))
    wg.contract(ws, partial, accumulate=False)
    assert ff.LAUNCHES["field_backward_v4_wgrad"] == 0
    scale = float(ref.abs().max())
    assert float((partial.sum(0) - ref).abs().max()) <= W_TOL * scale
    wg.contract(ws, partial, accumulate=True)
    assert float((partial.sum(0) - 2 * ref).abs().max()) <= 2 * W_TOL * scale
    w = wg.weight_grads(partial)
    assert [tuple(x.shape) for x in w] == [tuple(s) for s in
                                           tft.PACKED_SHAPES[:8]] + [(256,
                                                                      256)]
    assert torch.all(w[8][:, 16:128] == 0)
