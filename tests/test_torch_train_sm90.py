"""The train blob of K3, K7 and K1 at the train width
(rsn_torch/kernels/trunk_sm90.py, rsn_torch/csrc/train_sm90.cuh) on the
CPU: the normals' dgrad chunks round-trip to the packed weights exactly,
their schedule is the one trunk_sm90.cuh walks, a plain dgrad that reads
them in the kernels' order equals normals_dgrad_plain bit for bit and rsn's
field_forward_v6(want_normals=True) in interpret mode within the parity
tolerance, and the ReLU masks kept as the kernels' consumer threads keep
them (4 words a layer per thread, by fragment position) give back each
layer's mask.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rsn.kernels import field_pallas as fp
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import field_train as tft
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.models import model as model_lib
from rsn_torch.models.field import Field
from torch_parity import jax_params, n, port_field, rsn_params, t

HEADER = os.path.join(os.path.dirname(ts.__file__), "..", "csrc",
                      "trunk_sm90.cuh")
TOL = 2e-2  # test_torch_train_kernels.py's: bf16 products, fp32 sums
WG_THREADS = 128  # a consumer warpgroup's threads


# The kernels' register layout (trunk_sm90.cuh): register i of warpgroup
# thread t holds element (frag_row(t, i), frag_col(t, i)) of an m64nN fp32
# fragment, in the forward epilogue and in the dgrad drain alike.
def frag_row(t, i):
    return 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2)


def frag_col(t, i):
    return 8 * (i // 4) + 2 * (t % 4) + i % 2


def _frag_index(cols: int):
    t = torch.arange(WG_THREADS)[:, None]
    i = torch.arange(cols // 2)[None, :]
    return frag_row(t, i), frag_col(t, i)


def mask_words(h: torch.Tensor) -> torch.Tensor:
    """A warpgroup's 64 x 256 layer output (bf16) -> its ReLU mask as the
    consumer threads keep it (TrainHook): (128, 4) int64 words, bit i % 32
    of word i // 32 of thread t is h[frag_row(t, i), frag_col(t, i)] > 0."""
    r, c = _frag_index(256)
    bits = (h.float()[r, c] > 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64)
    return (bits.view(WG_THREADS, 4, 32) << shifts).sum(dim=-1)


def mask_from_words(words: torch.Tensor) -> torch.Tensor:
    """The dgrad drain's reading of the words: (128, 4) -> (64, 256)
    bool."""
    r, c = _frag_index(256)
    shifts = torch.arange(32, dtype=torch.int64)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(WG_THREADS, -1)
    out = torch.zeros(64, 256, dtype=torch.bool)
    out[r, c] = bits.bool()
    return out


@functools.lru_cache(maxsize=None)
def _packed(seed: int):
    field = Field(torch.Generator().manual_seed(seed)).eval()
    p3 = ff.pack_params_v3f(field)
    return (field, tft.pack_params_v4f(p3, field),
            ts.pack_train_blob(p3[:8], p3[16]))


def _mean_cov(rows: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    mc = np.zeros((rows, ff.IN_COLS), np.float32)
    mc[:, :3] = rng.uniform(-1.8, 1.8, (rows, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, (rows, 3))
    mc[: min(rows, 4), 3:6] = 0.0  # undamped top octaves
    return torch.from_numpy(mc)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("layer", range(8))
def test_dgrad_chunks_round_trip(seed, layer):
    """Each dgrad chunk of the layer, unswizzled, is its block of the bf16
    weight W_layer (rows r0..r0 + N, output columns k0..k0 + 64) bit for
    bit; the layer's chunks put back in place give W_layer whole, the x
    share's rows 104..127 (which no chunk holds) being zero padding."""
    _, p4, blob = _packed(seed)
    w = p4[layer]
    _, chunks = ts.train_blob_split(blob)
    mine = [c for c in chunks if c[0] == layer]
    assert len(mine) == (8 if layer == 4 else 4)
    for _, r0, rows, k0, block in mine:
        assert block.shape == (rows, 64)
        assert torch.equal(block, w[r0:r0 + rows, k0:k0 + 64])
        assert torch.equal(ts.dgrad_chunk(w, r0, rows, k0),
                           ts.swizzle_chunk(block.t()))
    assert torch.equal(ts.dgrad_weights(blob)[layer], w)
    if layer in (0, 4):
        assert not torch.any(w[ts.XS_N:128].float())


@pytest.mark.parametrize("seed", [0, 3])
def test_train_blob_layout_and_cast(seed):
    """The train blob is K1's blob (the trunk's 32 chunks, the heads' 4)
    followed by the 36 dgrad chunks: 2,146,304 bytes.  Packed from the fp32
    operands under autograd (transposed views included) it equals the blob
    of the bf16 operands, so it rounds as cast_packed does."""
    field, p4, blob = _packed(seed)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.numel() == ts.TRAIN_BLOB_ELEMS == 2146304 // 2
    fwd, _ = ts.train_blob_split(blob)
    assert torch.equal(fwd, ts.pack_blob(p4[:8], p4[16]))
    p32 = ff.pack_params_v3f_f32(field)
    assert not p32[1].is_contiguous()  # w1 is a transposed view
    assert torch.equal(tft.train_blob(p32[:8], p32[16]), blob)
    assert torch.equal(ts.pack_train_blob(p32[:8], p32[16]), blob)


def test_dgrad_schedule_matches_the_kernel():
    """dgrad_schedule is the order trunk_sm90.cuh walks (dgrad_layer,
    dgrad_x_share, dgrad_row0, transcribed here): layers 7, 6, 5, layer 4's
    x share (104 rows) then its h part (rows 128..383), layers 3, 2, 1 and
    layer 0's x share, 4 chunks of 64 output columns each, k ascending;
    36 chunks of 32 KB or 13 KB after the forward's 36."""
    src = open(HEADER).read()
    for line in ("return d < 12 ? LAYERS - 1 - d / 4 : d < 20 ? SKIP_AT : "
                 "3 - (d - 20) / 4;",
                 "return (d >= 12 && d < 16) || d >= 32;",
                 "return d >= 16 && d < 20 ? ENC : 0;",
                 "constexpr int DGRAD_CHUNKS = 36;",
                 "constexpr int XS_N = 104;",
                 "static_assert(blob_bytes(FWD_CHUNKS + DGRAD_CHUNKS) == "
                 "2146304,"):
        assert line in src, line

    def layer(d):
        return 7 - d // 4 if d < 12 else 4 if d < 20 else 3 - (d - 20) // 4

    want = [(layer(d), 128 if 16 <= d < 20 else 0,
             ts.XS_N if (12 <= d < 16 or d >= 32) else 256, 64 * (d % 4))
            for d in range(36)]
    assert ts.dgrad_schedule() == want
    sizes = [rows * 64 * 2 for _, _, rows, _ in want]
    assert sorted(set(sizes)) == [13312, 32768]
    assert 32 * 32768 + 4 * 144 * 128 + sum(sizes) == 2146304
    # the kernel's walk: 3 layers, the x share, the h part, 3 layers, the
    # x share (normals_wg), 4 chunks each
    body = open(os.path.join(os.path.dirname(HEADER),
                             "train_sm90.cuh")).read()
    # the build the port runs (not the ablation's register variant)
    body = re.sub(r"#ifdef RSN_ABLATE_XS_REGS.*?#else", "", body, flags=re.S)
    walk = re.findall(r"dgrad3_wg\(rp|dgrad_mma_wg<XS_N>|dgrad_wg\(rp, H, m\[3\]",
                      body[body.index("void normals_wg"):])
    assert walk == ["dgrad3_wg(rp", "dgrad_mma_wg<XS_N>",
                    "dgrad_wg(rp, H, m[3]", "dgrad3_wg(rp",
                    "dgrad_mma_wg<XS_N>"]


@pytest.mark.parametrize("seed,rows", [(0, 1), (1, 77), (3, 300)])
def test_dgrad_blob_walk_equals_normals_plain(seed, rows):
    """The normals' dgrad read from the blob's chunks in the kernels' order
    equals normals_dgrad_plain on the same seeded activations, bit for bit;
    a blob with two dgrad chunks swapped no longer does."""
    _, p4, blob = _packed(seed)
    mc = _mean_cov(rows, seed)
    hs = tft._trunk_acts(p4[:8], p4[8:16], ff.ipe_x(mc))
    want = tft.normals_dgrad_plain(p4, hs, mc)
    got = tft.normals_blob_plain(blob, p4[20], hs, mc)
    assert torch.equal(got, want)
    c = 64 * 256
    off = blob.numel() - 4 * 64 * ts.XS_N - 3 * 4 * c  # layer 3's chunks
    bad = blob.clone()
    bad[off:off + c], bad[off + c:off + 2 * c] = (blob[off + c:off + 2 * c],
                                                  blob[off:off + c])
    assert not torch.equal(tft.normals_blob_plain(bad, p4[20], hs, mc), want)


def test_dgrad_blob_walk_matches_rsn():
    """The blob walk's d density_preact / d mean against rsn's
    field_forward_v6(want_normals=True) in interpret mode (V4_DPDM), at
    test_k3_plain_matches_field_forward_v6's tolerance: unit vectors
    within TOL, cos >= 0.999 on the rows with a live gradient."""
    R, S = 8, 8
    tree = rsn_params(0)
    rng = np.random.default_rng(1)
    mc = np.zeros((R * S, 16), np.float32)
    mc[:, :3] = rng.normal(size=(R * S, 3)) * 0.5
    mc[:, 3:6] = np.abs(rng.normal(size=(R * S, 3))) * 1e-2
    params = jax_params(tree)
    g = fp.mid_g_bands(params, jnp.zeros((R, 3)).at[:, 2].set(1.0))
    out_j, _ = fp.field_forward_v6(fp.pack_params_v4f(params),
                                   jnp.asarray(mc), g, S, tile=32,
                                   want_normals=True, interpret=True)
    field = port_field(tree)
    p4 = tft.pack_params_v4f(ff.pack_params_v3f(field), field)
    blob = ts.pack_train_blob(p4[:8], p4[16])
    hs = tft._trunk_acts(p4[:8], p4[8:16], ff.ipe_x(t(mc)))
    got = n(tft.normals_blob_plain(blob, p4[20], hs, t(mc)))
    dj = np.asarray(out_j, np.float32)[:, tft.V4_DPDM]
    unit = lambda v: -v / np.maximum(
        np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    np.testing.assert_allclose(unit(got), unit(dj), atol=TOL)
    live = np.linalg.norm(dj, axis=-1) > 1e-3
    assert live.any()
    assert np.sum(unit(got) * unit(dj), axis=-1)[live].min() >= 0.999


@pytest.mark.parametrize("layer", range(8))
def test_fragment_masks_round_trip(layer):
    """A layer's ReLU mask as the consumer threads keep it (bit i of
    thread t: the bf16 output at (frag_row(t, i), frag_col(t, i)) > 0, 4
    words a layer) gives back hs[layer] > 0 on a warpgroup's 64 rows."""
    _, p4, _ = _packed(0)
    mc = _mean_cov(64, layer)
    hs = tft._trunk_acts(p4[:8], p4[8:16], ff.ipe_x(mc))
    words = mask_words(hs[layer])
    assert words.shape == (WG_THREADS, 4)
    assert int(words.min()) >= 0 and int(words.max()) < 2 ** 32
    mask = hs[layer].float() > 0
    assert 0 < int(mask.sum()) < mask.numel()
    assert torch.equal(mask_from_words(words), mask)


@pytest.mark.parametrize("cols", [256, 144, 104])
def test_fragment_positions_cover_the_tile(cols):
    """The m64nN fragment map of trunk_sm90.cuh (register i of warpgroup
    thread t at (frag_row, frag_col)) puts every element of the 64 x N
    accumulator in exactly one register of one thread, for the trunk's
    and the dgrad's N = 256, the heads' 144 and the x share's 104; the
    same register of the same thread holds an element in the forward
    epilogue and in the dgrad drain, which is what the masks rely on."""
    tt, ii = np.meshgrid(np.arange(WG_THREADS), np.arange(cols // 2),
                         indexing="ij")
    r, c = frag_row(tt, ii), frag_col(tt, ii)
    assert r.min() == 0 and r.max() == 63 and c.min() == 0
    assert c.max() == cols - 1
    flat = np.sort((r * cols + c).ravel())
    assert np.array_equal(flat, np.arange(64 * cols))


def test_train_operands_carry_a_blob_only_on_the_card():
    """pack_train_operands packs the blob where the field lives on a card
    (one launch a step); on the CPU the plain versions need none.  The
    forwards take the blob as an optional argument and ignore it on the
    CPU."""
    field, p4, blob = _packed(0)
    ops = model_lib.pack_train_operands(field)
    assert ops.blob is None and len(ops.packed_f32) == 20
    mc = _mean_cov(16, 0)
    g = torch.zeros(2, 512)
    a = tft.field_forward_v6(p4, mc, g, 8, True, blob=blob)
    b = tft.field_forward_v6(p4, mc, g, 8, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(tft.field_forward_v4(p4, mc, g, 8, blob=blob),
                       tft.field_forward_v4(p4, mc, g, 8))
    assert ff.LAUNCHES["train_blob"] == 0
