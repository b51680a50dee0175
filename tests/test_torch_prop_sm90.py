"""K9's register-resident design on the CPU: the plain helpers of
rsn_torch/kernels/proposal_forward.py that mirror the kernel's mma.sync
m16n8k16 fragments (which lane and register hold which (row, column) of
an m-tile, the chain from one layer's sums to the next layer's operand,
the head's gather order) and its IPE factored to one exp per (row, d, k),
against prop_ipe bit for bit and against rsn's prop_forward in Pallas
interpret mode."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rsn.kernels import proposal_pallas as jpp
from rsn.models import proposal as jprop
from rsn_torch.engine import checkpoints as tckpt
from rsn_torch.kernels import proposal_forward as pf
from rsn_torch.models import proposal as tprop
from torch_parity import jax_params, n, t

TILE = (pf.MMA_ROWS, pf.ENC_PAD)


def _cells(coords: np.ndarray) -> np.ndarray:
    """(..., 2) (row, column) pairs -> a count per cell of one m-tile."""
    counts = np.zeros(TILE, np.int64)
    np.add.at(counts, (coords[..., 0].ravel(), coords[..., 1].ravel()), 1)
    return counts


@pytest.mark.parametrize("name", ["a", "c"])
def test_fragment_map_covers_the_tile_once(name):
    """Every (row, column) of a 16 x 64 m-tile sits in exactly one (lane,
    register) of the A operand (4 k-steps x 4 registers x 2 halves) and of
    the fp32 sums (8 n-tiles x 4 values)."""
    coords = pf.a_fragment_map() if name == "a" else pf.c_fragment_map()
    assert np.array_equal(_cells(coords), np.ones(TILE, np.int64))


def test_sums_become_the_next_layers_operand_in_place():
    """The epilogue's C -> A move stays in the lane: value i of n-tile j
    and the A half that c_to_a(j, i) names hold the same (row, column), and
    the move reaches every A half once."""
    amap, cmap = pf.a_fragment_map(), pf.c_fragment_map()
    seen = set()
    for lane in range(32):
        for j in range(pf.N_TILES):
            for i in range(4):
                ks, r, e = pf.c_to_a(j, i)
                assert tuple(amap[lane, ks, r, e]) == tuple(cmap[lane, j, i])
                seen.add((lane, ks, r, e))
    assert len(seen) == amap[..., 0].size


def test_head_gathers_each_quarter_in_the_first_designs_order():
    """Lane t of group g reads, step by step, columns t, t + 4, ..., t + 60
    of row g + 8 h from lanes of its own group: the fma chain of the first
    design's thread q = t for that row."""
    amap, gmap = pf.a_fragment_map(), pf.head_gather_map()
    for lane in range(32):
        g, q = divmod(lane, 4)
        for h in range(2):
            cols = []
            for src, ks, r, e in gmap[lane, h]:
                assert src // 4 == g
                row, col = amap[src, ks, r, e]
                assert row == g + 8 * h
                cols.append(col)
            assert cols == list(range(q, pf.ENC_PAD, 4))


def test_each_lane_owns_both_halves_of_its_frequencies():
    """Lane t holds the sine and the cosine column of (d, k) for k in
    {2 t, 2 t + 1} and every d, and no other IPE column: one damping per
    (d, k) serves both, 24 exp a row where prop_ipe takes 48."""
    amap = pf.a_fragment_map()
    for lane in range(4):
        cols = set(amap[lane, ..., 1].ravel().tolist())
        ipe = {c for c in cols if c < 6 * pf.PROP_NUM_FREQS}
        want = {half * 24 + d * 8 + k for half in range(2) for d in range(3)
                for k in (2 * lane, 2 * lane + 1)}
        assert ipe == want


def _ipe_rows(rows: int, seed: int) -> np.ndarray:
    """Seeded (rows, 16) f32 inputs: means up to +-2 (phases to 2 pi 256 2
    ~ 3.2e3 rad), some near 2 itself, small and zero variances, and rows
    that carry NaN, +inf and -inf."""
    rng = np.random.default_rng(seed)
    mc = np.zeros((rows, 16), np.float32)
    mc[:, 0:3] = rng.uniform(-2.0, 2.0, size=(rows, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, size=(rows, 3)) ** 2
    mc[: rows // 4, 0:3] = np.float32(2.0) - rng.uniform(
        0.0, 1e-3, size=(rows // 4, 3)).astype(np.float32)
    mc[:: 5, 3:6] = 0.0
    special = [np.nan, np.inf, -np.inf]
    for i in range(min(rows, 6)):
        mc[i, i % 6] = special[i % 3]
    return mc


@pytest.mark.parametrize("rows", [1, 7, 64, 1001, 4099])
def test_factored_ipe_equals_prop_ipe_bit_for_bit(rows):
    mc = t(_ipe_rows(rows, rows))
    want = pf.prop_ipe(mc)
    got = pf.prop_ipe_factored(mc)
    assert got.shape == want.shape == (rows, pf.ENC_PAD)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if rows >= 4:  # a quarter of the rows sit just under mean 2
        mean = mc[:, 0:3].abs()
        reach = float(mean[torch.isfinite(mean)].max()) * pf.PROP_SCALE.max()
        assert reach > 3.2e3


def test_factored_ipe_keeps_nan_and_inf_rows_as_prop_ipe_does():
    """A NaN mean makes its own IPE columns NaN; an infinite mean makes the
    sines NaN; an infinite variance damps them to 0 * sin = 0 or NaN; the
    other rows are untouched."""
    mc = np.zeros((4, 16), np.float32)
    mc[:, 0:3] = 0.5
    mc[0, 0] = np.nan
    mc[1, 1] = np.inf
    mc[2, 5] = np.inf
    got = pf.prop_ipe_factored(t(mc))
    want = pf.prop_ipe(t(mc))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isnan(got[0, 0:8]).all() and torch.isfinite(got[3]).all()
    assert torch.isnan(got[1, 8:16]).all()
    assert torch.all(got[2, 16:24] == 0.0)


@pytest.mark.parametrize("rows", [64, 208])
def test_trunk_on_the_factored_ipe_matches_pallas_interpret(rows):
    """The plain trunk and head on the factored IPE against rsn's
    prop_forward in interpret mode (the tile padded to 64 rows), within
    1e-2 of max |preact|, as for the plain version."""
    tree = jax.tree.map(np.asarray,
                        jprop.init_proposal_params(jax.random.PRNGKey(2)))
    prop = tprop.ProposalField()
    prop.load_state_dict(tckpt.proposal_from_rsn(tree))
    mc = _ipe_rows(rows, 11)
    mc[:6] = np.abs(np.nan_to_num(mc[:6], posinf=1.0, neginf=-1.0))
    pad = -(-rows // 64) * 64
    ref = np.asarray(jpp.prop_forward(
        jpp.pack_prop_params(jax_params(tree)),
        jnp.asarray(np.pad(mc, ((0, pad - rows), (0, 0)))), tile=64,
        interpret=True))[:rows]
    packed = pf.pack_prop_params(prop)
    ws, bs = packed[:4], packed[4:8]
    wd, bd = packed[8:]
    h = pf.prop_ipe_factored(t(mc)).to(torch.bfloat16)
    for w, b in zip(ws, bs):
        h = torch.relu(h.float() @ w.float() + b).to(torch.bfloat16)
    got = n((h.float() @ wd.float() + bd)[:, 0])
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    assert np.array_equal(got, n(pf.prop_forward_plain(packed, t(mc))))
