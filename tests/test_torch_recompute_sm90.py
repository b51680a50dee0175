"""K13 (field_backward_v3) and K17 (field_backward_whole) on K8's kernel A
and kernel B, on the CPU: their chunked plain versions and the plain K13
sum (rsn_torch/kernels/field_train.py).

K17's kernel A walks each block's run in 128-row tiles and stashes each
tile's two 64-row halves as the records of K8's 64-row tiles; its plain
stash (whole_chunk_plain) gives K8's records (stash_chunk_plain) chunk by
chunk bit for bit, over one chunk and several, odd tile counts (a last
tile whose second half has no rows) and blocks whose runs end early, so
its nine weight matrices are K8's bit for bit.  K13's sum launch adds
kernel B's P partials in slice order and the blocks' compact slices in
block order; k13_sum_plain lays the 20 gradients out as stash_grads does
(exact on integer-valued inputs, where every order sums alike) and adds
in that order.  The chunked plain K13 and K17 agree with rsn's
field_backward_v3 and with rsn's field_backward_v4(n_halves=1) (the
equivalent tools/exp_bwd_whole.py names; the tool exits at import) in
interpret mode, at R=8 rays, S=8 samples, 32-row tiles on the JAX side,
within TOL of each tensor's max: bf16 products with fp32 sums in another
order, as tests/test_torch_train_kernels.py holds K8.  The kernels
themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn.kernels import field_train as jft
from rsn_torch.experiments import bwd_whole
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import wgrad_sm90 as wg
from rsn_torch.models.field import Field
from torch_parity import jax_params, n, port_field, rsn_params, t

CSRC = os.path.join(os.path.dirname(tft.__file__), "..", "csrc")
TOL = 2e-2
WEIGHTS = list(range(8)) + [16]  # w0..w7, w_hc: kernel B's sums
# (R, S, sms): one chunk of one tile (odd); ragged; one ray; 10 tiles in 3
# chunks; two blocks whose second run ends 3 tiles early, 7 tiles (odd) in
# 2 chunks; 9 tiles in 3 chunks, the last of one tile
SHAPES = [(8, 8, 132), (3, 7, 132), (1, 1, 132), (3, 200, 1), (3, 200, 2),
          (6, 90, 1)]


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


@pytest.mark.parametrize("R,S,sms", SHAPES)
def test_k17_records_equal_k8s(R, S, sms):
    """K17's plain stash, walked in 128-row tiles, gives K8's records chunk
    by chunk, bit for bit (zero records and rows included)."""
    packed, mc, g, d_out, out = _inputs(R, S, R + S)
    x = ff.ipe_x(mc)
    hs = tft._trunk_acts(packed[:8], packed[8:16], x)
    ops = {}
    tft._backward_plain(packed[:tft.N_PACKED], g, hs, x, d_out, out, S, mc,
                        ops)
    plan = tft.stash_plan(R, S, sms)
    for chunk in plan.chunks:
        assert torch.equal(tft.whole_chunk_plain(plan, chunk, x, hs, ops),
                           tft.stash_chunk_plain(plan, chunk, x, hs, ops))
    if (R, S, sms) in ((3, 200, 2), (6, 90, 1)):
        assert plan.tiles % 2 == 1 and len(plan.chunks) >= 2


@pytest.mark.parametrize("R,S,sms", [(3, 7, 132), (3, 200, 2), (6, 90, 1)])
def test_k17_weights_equal_k8s(R, S, sms):
    """The chunked plain K17's dmc and nine weight matrices (w0..w7, w_hc)
    equal the chunked plain K8's bit for bit: kernel B sums the same
    records in the same order."""
    args = _inputs(R, S, 2 * R + S)
    k17 = tft.field_backward_whole_chunked_plain(*args, S, sms)
    k8 = tft.field_backward_v4_chunked_plain(*args, S, sms)
    assert torch.equal(k17[0], k8[0])
    for i in WEIGHTS:
        assert torch.equal(k17[2][i], k8[2][i]), i


@pytest.mark.parametrize("R,S,sms", [(1024, 128, 132), (1000, 64, 132),
                                     (40, 200, 36), (3, 200, 1)])
def test_chunks_start_on_even_tiles(R, S, sms):
    """K8's plan, which K17 runs: every chunk starts on an even tile and
    ends on one or at the last tile, so no 128-row tile of K17 straddles
    two chunks."""
    plan = tft.stash_plan(R, S, sms)
    for t0, t1 in plan.chunks:
        assert t0 % 2 == 0 and (t1 % 2 == 0 or t1 == plan.tiles)


@pytest.mark.parametrize("blocks,slices", [(1, 1), (5, 3), (128, 7)])
def test_k13_sum_plain_lays_out_as_stash_grads(blocks, slices):
    """On integer-valued slices and partials (every order of the fp32 sums
    exact) k13_sum_plain gives stash_grads' 20 gradients bit for bit:
    w_hc's 144 columns spread to 256, w_out's and b_out's 3 live columns,
    zeros between; the wrapper k13_sum on CPU tensors returns them flat
    and counts no launch."""
    rng = np.random.default_rng(blocks + slices)
    small = torch.from_numpy(rng.integers(-64, 64, (blocks, tft.SMALL_FLOATS))
                             .astype(np.float32))
    partial = torch.from_numpy(rng.integers(-64, 64, (
        slices, wg.PARTIAL_FLOATS)).astype(np.float32))
    got = tft.k13_sum_plain(small, partial)
    want = tft.stash_grads(small, partial)
    assert [tuple(a.shape) for a in got] == [tuple(s) for s in
                                             tft.PACKED_SHAPES]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.all(got[16][:, 16:128] == 0)
    assert torch.all(got[18][:, 3:] == 0) and torch.all(got[19][:, 3:] == 0)
    ff.reset_launch_counts()
    flat = tft.k13_sum(small, partial)
    assert ff.LAUNCHES["field_backward_v3_sum"] == 0
    assert flat.shape == (tft.PACK_FLOATS,)
    assert torch.equal(flat, torch.cat([a.reshape(-1) for a in got]))


def test_k13_sum_plain_adds_in_slice_and_block_order():
    """k13_sum_plain's fp32 sums run 0 + x_0 + x_1 + ... in slice (block)
    order, the kernel's order: on terms where the order matters it gives
    the sequential sum, whatever torch.sum gives."""
    terms = np.array([1e8, 1.0, -1e8, 1.0, 3.0, -7.0, 0.5], np.float32)
    small = torch.zeros((len(terms), tft.SMALL_FLOATS))
    partial = torch.zeros((len(terms), wg.PARTIAL_FLOATS))
    small[:, 0] = torch.from_numpy(terms)        # b0[0]
    partial[:, 0] = torch.from_numpy(terms)      # w0[0, 0]
    partial[:, -1] = torch.from_numpy(terms[::-1].copy())  # w_hc[255, 255]
    seq = lambda v: float(np.cumsum(v, dtype=np.float32)[-1])
    got = tft.k13_sum_plain(small, partial)
    assert float(got[8][0, 0]) == seq(terms)
    assert float(got[0][0, 0]) == seq(terms)
    assert float(got[16][255, 255]) == seq(terms[::-1])


def test_k17_kernel_a_fits_one_sm():
    """K17's kernel A: its 128-row body (194,560 bytes) and one 32 KB
    staging buffer, 227,328 bytes, within the 232,448 a block can take,
    stated in field_train.cu's static_assert; two buffers would not fit."""
    rows, ldh, ldx, rf = 128, 264, 136, 24
    body = (2 * rows * ldh * 2 + rows * ldx * 2 + rows * rf * 4
            + rows * 4 * 4 + 8 * 16 * 20 * 4)
    assert body == 194560
    assert body + 32768 == 227328 <= 232448 < body + 2 * 32768
    src = open(os.path.join(CSRC, "field_train.cu")).read()
    assert re.search(r"static_assert\(K17A_SMEM_BYTES <= 232448", src)
    assert "K17_SMEM_BYTES + wgrad::STAGING_BYTES" in src
    assert "#ifdef RSN_K13_FIRST_DESIGN" in src


@pytest.fixture(scope="module")
def rsn_inputs():
    R, S = 8, 8
    tree = rsn_params(0)
    params = jax_params(tree)
    rng = np.random.default_rng(1)
    mc = np.zeros((R * S, 16), np.float32)
    mc[:, :3] = rng.normal(size=(R * S, 3)).astype(np.float32) * 0.5
    mc[:, 3:6] = np.abs(rng.normal(size=(R * S, 3))).astype(np.float32) * 1e-2
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = np.asarray(fp.mid_g_bands(params, jnp.asarray(dirs)))
    d_out = rng.normal(size=(R * S, fp.V3_OUT)).astype(np.float32)
    d_out[:, 14:20] = 0.0
    dj = jnp.asarray(d_out).astype(jnp.bfloat16)
    out_j = fp.field_forward_v4(fp.pack_params_v4f(params), jnp.asarray(mc),
                                jnp.asarray(g), S, tile=32, interpret=True)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                      ).to(torch.bfloat16).contiguous()
    port = (ff.pack_params_v3f(port_field(tree)), t(mc), t(g),
            to_t(dj[:, :tft.OUT_TRAIN]), to_t(out_j[:, :tft.OUT_TRAIN]), S)
    jax_args = (fp.pack_params_v3f(params), jnp.asarray(mc), jnp.asarray(g),
                dj, out_j, S)
    return port, jax_args


def _close(a, b, name):
    b = np.asarray(b, np.float32)
    scale = max(float(np.abs(b).max()), 1e-6)
    assert float(np.abs(n(a) - b).max()) <= TOL * scale, name


def _hold(got, want):
    dmc_j, dg_j, dpk_j = want
    _close(got[0], dmc_j, "dmc")
    _close(got[0][:, 3:6], np.asarray(dmc_j)[:, 3:6], "dmc cov")
    _close(got[1], dg_j, "dg")
    assert len(got[2]) == 20
    for i, (a, b) in enumerate(zip(got[2], dpk_j)):
        assert tuple(a.shape) == tuple(b.shape), i
        _close(a, b, f"dpacked[{i}]")


def test_k13_chunked_plain_matches_rsn_field_backward_v3(rsn_inputs):
    """The chunked plain K13 on 2 SMs (4 blocks: 4 compact slices and P
    partials summed in order) against rsn's whole-grid field_backward_v3
    in interpret mode."""
    port, jax_args = rsn_inputs
    want = jft.field_backward_v3(*jax_args, tile=32, interpret=True)
    _hold(tft.field_backward_v3_chunked_plain(*port, 2), want)


def test_k17_chunked_plain_matches_rsn_whole_tile_backward(rsn_inputs):
    """The chunked plain K17 on 2 SMs against rsn's field_backward_v4 with
    one whole-tile chain (n_halves=1, the tool's equivalent) in interpret
    mode; the wrapper on CPU tensors is K8's plain version."""
    port, jax_args = rsn_inputs
    want = jft.field_backward_v4(*jax_args, tile=32, inner=2,
                                 interpret=True, n_halves=1)
    got = tft.field_backward_whole_chunked_plain(*port, 2)
    _hold(got, want)
    ff.reset_launch_counts()
    plain = bwd_whole.field_backward_whole(*port)
    assert set(ff.LAUNCHES.values()) == {0}
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])
