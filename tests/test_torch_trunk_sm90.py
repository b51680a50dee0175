"""K1's and K2's weight ring (rsn_torch/kernels/trunk_sm90.py) on the CPU:
the pre-packed blob round-trips to the packed weights exactly, a plain
trunk that reads the blob chunk by chunk in the kernels' order equals
field_forward._trunk_plain exactly in fp32, and the chunk schedule is the
one rsn_torch/csrc/trunk_sm90.cuh walks.  The kernels themselves run only
on a card (tests/test_torch_cuda.py)."""
import os
import re

import numpy as np
import pytest
import torch

from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.models.field import Field

HEADER = os.path.join(os.path.dirname(ts.__file__), "..", "csrc",
                      "trunk_sm90.cuh")


def _field(seed: int) -> Field:
    return Field(torch.Generator().manual_seed(seed)).eval()


def _mean_cov(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    mc = np.zeros((n, ff.IN_COLS), np.float32)
    mc[:, :3] = rng.uniform(-1.8, 1.8, (n, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, (n, 3))
    mc[: min(n, 4), 3:6] = 0.0  # undamped top octaves
    return torch.from_numpy(mc)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("heads", [True, False])
def test_blob_round_trips(seed, heads):
    """unpack(pack(w0..w7, w_hc)) gives back w0..w7 and w_hc's 144 used
    columns bit for bit; the blob is 32 trunk chunks of 64 x 256 and, for
    K1, 4 head chunks of 64 x 144."""
    field = _field(seed)
    packed = ff.pack_params_v3f(field) if heads else ff.pack_params_density(
        field)
    blob = ts.pack_blob(packed[:8], packed[16] if heads else None)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.numel() == 32 * 64 * 256 + (4 * 64 * 144 if heads else 0)
    ws, w_heads = ts.unpack_blob(blob)
    for got, want in zip(ws, packed[:8]):
        assert torch.equal(got, want)
    if heads:
        assert torch.equal(w_heads, torch.cat([packed[16][:, :16],
                                               packed[16][:, 128:]], 1))
    else:
        assert w_heads is None


@pytest.mark.parametrize("n", [1, 37, 200])
def test_swizzle_layout(n):
    """Each chunk row is 128 bytes with 16-byte group g of row r at position
    g ^ (r % 8) (the K-major 128-byte swizzle wgmma reads), and
    unswizzle_chunk inverts it."""
    rng = np.random.default_rng(n)
    block = torch.from_numpy(rng.standard_normal((64, n)).astype(
        np.float32)).to(torch.bfloat16)
    chunk = ts.swizzle_chunk(block)
    for r in range(n):
        for k in range(64):
            pos = r * 64 + (((k // 8) ^ (r % 8)) * 8) + k % 8
            assert chunk[pos] == block[k, r]
    assert torch.equal(ts.unswizzle_chunk(chunk, n), block)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 77), (3, 300)])
def test_blob_walk_equals_trunk_plain(seed, n):
    """The trunk read from the blob in the kernels' chunk order equals
    _trunk_plain on the same seeded inputs, exactly (fp32 sums, bf16
    activations): the chunks hold every weight at its place."""
    field = _field(seed)
    packed = ff.pack_params_v3f(field)
    x = ff.ipe_x(_mean_cov(n, seed))
    blob = ts.pack_blob(packed[:8], packed[16])
    got = ts.trunk_blob_plain(blob, packed[8:16], x)
    want = ff._trunk_plain(packed[:8], packed[8:16], x)
    assert torch.equal(got, want)
    # a blob with two chunks swapped no longer gives the trunk
    c = 64 * 256
    bad = blob.clone()
    bad[2 * c:3 * c], bad[3 * c:4 * c] = blob[3 * c:4 * c], blob[2 * c:3 * c]
    assert not torch.equal(ts.trunk_blob_plain(bad, packed[8:16], x), want)


def test_schedule_matches_the_kernels():
    """trunk_schedule is the order trunk_sm90.cuh walks: layer_chunks (2, 4,
    4, 4, 6, 4, 4, 4; 32 chunks), 3 k-steps on the second chunk of layers 0
    and 4 (the IPE's rows 64..127, of which 112..127 meet zero columns:
    trunk_wg's default, which K1 and K2 take), and the ring's chunk
    sizes."""
    sched = ts.trunk_schedule()
    per_layer = [sum(1 for s in sched if s[0] == i) for i in range(8)]
    assert per_layer == [2, 4, 4, 4, 6, 4, 4, 4]
    assert [(l, k0) for l, k0, ks in sched if ks == 3] == [(0, 64), (4, 64)]
    src = open(HEADER).read()
    assert "return layer == 0 ? 2 : layer == SKIP_AT ? 6 : 4;" in src
    assert re.search(r"TRUNK_CHUNKS = 32;", src)
    assert re.search(r"HEAD_CHUNKS = 4;", src)
    assert re.search(r"template <int X_LAST_KSTEPS = 3, typename Hook", src)
    assert re.search(r"x_first && j == 1 \? X_LAST_KSTEPS : 4", src)


def test_packed_operands_keep_their_blob():
    """pack_params_v3f / pack_params_density return tuples that keep the
    ring's blob once built (one packing per render, not per chunk); a plain
    sequence gets a fresh blob each time; the tuples still hold the same
    operands in the same order."""
    field = _field(0)
    p3, pd = ff.pack_params_v3f(field), ff.pack_params_density(field)
    assert isinstance(p3, tuple) and len(p3) == 20 and len(pd) == 18
    b3 = ff._ring_blob(p3, heads=True)
    assert ff._ring_blob(p3, heads=True) is b3
    assert torch.equal(b3, ts.pack_blob(p3[:8], p3[16]))
    bd = ff._ring_blob(pd, heads=False)
    assert torch.equal(bd, b3[:bd.numel()])
    plain = list(pd)
    assert ff._ring_blob(plain, heads=False) is not ff._ring_blob(
        plain, heads=False)
