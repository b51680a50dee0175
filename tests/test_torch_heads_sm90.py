"""K11's and K12's Hopper kernels (rsn_torch/csrc/heads_sm90.cuh) on the
CPU: their weight blob (unfolded_sm90.pack_heads_blob) round-trips to
pack_params' trunk weights and wh's two parts exactly, equals the first 40
chunks of K14's unfolded blob, and is kept per PackedOperands under its own
format; a plain forward that reads every weight back from the blob equals
field_forward_v2_plain and field_forward_plain exactly, and rsn's
field_forward_v2 / field_forward in interpret mode (256 rows, atol / rtol
2e-2, column by column); the headers' chunk constants are the packer's.
The kernels themselves run only on a card (tests/test_torch_cuda.py)."""
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from rsn.kernels import field_pallas as fp
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import unfolded_sm90 as us
from torch_parity import jax_params, n, port_field, rsn_params, t

CSRC = os.path.join(os.path.dirname(us.__file__), "..", "csrc")
ROWS = 256  # rsn's side: two 128-row tiles
TOL = 2e-2  # bf16 outputs, fp32 sums in another order
OUT_COLS = {"bottleneck": ff.OUT_BOTTLENECK,
            "density": slice(ff.OUT_DENSITY, ff.OUT_DENSITY + 1),
            "diff": ff.OUT_DIFF, "tint": ff.OUT_TINT,
            "rough": slice(ff.OUT_ROUGH, ff.OUT_ROUGH + 1),
            "normals": ff.OUT_NORMALS}


@functools.lru_cache(maxsize=None)
def _tree(seed: int):
    return rsn_params(seed)


def _field(seed: int):
    return port_field(_tree(seed))


def _mean_cov(rows: int, seed: int) -> np.ndarray:
    """(rows, 16) f32 [mean | cov_diag | 0]: covariances over decades, the
    first rows undamped (phases ~8e5 at the top octave)."""
    rng = np.random.default_rng(seed)
    mc = np.zeros((rows, ff.IN_COLS), np.float32)
    mc[:, 0:3] = rng.uniform(-1.8, 1.8, size=(rows, 3))
    mc[:, 3:6] = 10.0 ** rng.uniform(-9.0, -2.0, size=(rows, 3))
    mc[:8, 3:6] = 0.0
    return mc


def heads_blob_plain(blob: torch.Tensor, packed, x: torch.Tensor):
    """field_forward_plain with every weight read back from the kernels'
    blob (the biases from packed): x (N, 128) bf16 -> (N, 384) bf16."""
    ws, tail = us.unpack_unfolded_blob(blob, us.HEADS_PARTS)
    wh = torch.zeros_like(packed[16])
    wh[:, :us.HEAD_COL0] = tail["bottleneck"]
    wh[:, us.HEAD_COL0:us.HEAD_COL0 + us.HEAD_NCOLS] = tail["head_cols"]
    return ff.field_forward_plain(
        tuple(ws) + tuple(packed[8:16]) + (wh, packed[17]), x)


@pytest.mark.parametrize("seed", [0, 3])
def test_heads_blob_round_trips(seed):
    """unpack(pack(pack_params)) gives back w0..w7 and wh's bottleneck and
    head columns bit for bit; the blob is the trunk's 32 chunks of 64 x 256,
    then 4 x (64 x 16) and 4 x (64 x 256), and holds nothing else."""
    packed = ff.pack_params(_field(seed))
    blob = us.pack_heads_blob(packed)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.numel() == 64 * (32 * 256 + 4 * (16 + 256))
    ws, tail = us.unpack_unfolded_blob(blob, us.HEADS_PARTS)
    for got, want in zip(ws, packed[:8]):
        assert torch.equal(got, want)
    assert set(tail) == {"head_cols", "bottleneck"}
    assert torch.equal(tail["head_cols"], packed[16][:, 256:272])
    assert torch.equal(tail["bottleneck"], packed[16][:, :256])
    # the columns the blob leaves out are zero in the operands
    assert torch.all(packed[16][:, 267:] == 0)
    with pytest.raises(ValueError, match="unfolded blob"):
        us.unpack_unfolded_blob(blob[:-64], us.HEADS_PARTS)


@pytest.mark.parametrize("seed", [0, 3])
def test_heads_blob_is_the_unfolded_blobs_first_40_chunks(seed):
    """The same packer: K11's / K12's blob is K14's blob cut before the mid
    seed's 4 chunks."""
    field = _field(seed)
    blob = us.pack_heads_blob(ff.pack_params(field))
    unfolded = us.pack_unfolded_blob(ff.pack_params_v3(field))
    assert unfolded.numel() - blob.numel() == 4 * 64 * 128
    assert torch.equal(blob, unfolded[:blob.numel()])


def test_heads_blob_is_kept_per_packed_tuple():
    """pack_params returns a PackedOperands that keeps its blob from the
    first use on, in its own "heads" slot; a plain sequence gets a fresh
    one."""
    packed = ff.pack_params(_field(1))
    assert isinstance(packed, ff.PackedOperands) and len(packed) == 18
    first = ff.heads_blob(packed)
    assert ff.heads_blob(packed) is first
    assert packed.blobs == {"heads": first}
    assert torch.equal(first, us.pack_heads_blob(packed))
    plain = tuple(packed)
    assert ff.heads_blob(plain) is not ff.heads_blob(plain)
    assert torch.equal(ff.heads_blob(plain), first)


@pytest.mark.parametrize("seed,rows", [(0, 1), (1, 77), (3, 300)])
@pytest.mark.parametrize("front", ["ipe", "enc", "enc_tail"])
def test_blob_plain_equals_plain_versions(seed, rows, front):
    """The forward read from the blob (every weight as the kernels stream
    it) equals the plain K11 (the exact IPE) and K12 (an encoding; with a
    non-zero tail in columns 99..127, which the ring's layer-0 and layer-4
    chunks carry as zero weight rows) exactly."""
    packed = ff.pack_params(_field(seed))
    mc = t(_mean_cov(rows, seed))
    blob = us.pack_heads_blob(packed)
    if front == "ipe":
        want = ff.field_forward_v2_plain(packed, mc)
        got = heads_blob_plain(blob, packed, ff.ipe_enc(mc))
    else:
        enc = ff.ipe_enc(mc)
        if front == "enc_tail":
            rng = np.random.default_rng(seed)
            enc[:, ff.IPE_OUT_DIM:] = t(rng.normal(
                size=(rows, ff.ENC_PAD - ff.IPE_OUT_DIM)) * 3).to(
                    torch.bfloat16)
        want = ff.field_forward_plain(packed, enc)
        got = heads_blob_plain(blob, packed, enc)
    assert got.shape == (rows, ff.OUT_DIM) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.all(got[:, ff.N_HEAD_COLS:] == 0)


@pytest.fixture
def interpret(monkeypatch):
    """rsn's field_forward_v2 / field_forward in interpret mode."""
    monkeypatch.setattr(fp.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("kernel", ["field_forward_v2", "field_forward"])
def test_blob_plain_matches_rsn(kernel, interpret):
    """The forward read from the blob against rsn's K11 / K12 on 256 rows
    (rsn's own encoding for K12), head by head over the OUT_* columns; the
    padding [267, 384) zero in both."""
    tree = _tree(0)
    packed = ff.pack_params(port_field(tree))
    jpack = fp.pack_params(jax_params(tree))
    mc = _mean_cov(ROWS, 5)
    if kernel == "field_forward_v2":
        ref = fp.field_forward_v2(jpack, jnp.asarray(mc), tile=ROWS // 2)
        enc = ff.ipe_enc(t(mc))
    else:
        enc_j = fp._ipe_in_kernel(jnp.asarray(mc), *fp.ipe_matrices())
        ref = fp.field_forward(jpack, enc_j, tile=ROWS // 2)
        enc = t(enc_j).to(torch.bfloat16)
    got = n(heads_blob_plain(us.pack_heads_blob(packed), packed, enc))
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (ROWS, ff.OUT_DIM)
    for name, cols in OUT_COLS.items():
        np.testing.assert_allclose(got[:, cols], ref[:, cols], atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert np.all(got[:, ff.N_HEAD_COLS:] == 0)
    assert np.all(ref[:, ff.N_HEAD_COLS:] == 0)


def test_header_constants_are_the_packers():
    """trunk_sm90.cuh's heads chunk map (HC_N, HEADS_TILE_CHUNKS) and
    heads_sm90.cuh's blob size are the packer's; K11's trunk takes 3
    k-steps on the x part's second chunk, K12's 4."""
    trunk = open(os.path.join(CSRC, "trunk_sm90.cuh")).read()
    heads = open(os.path.join(CSRC, "heads_sm90.cuh")).read()
    assert re.search(r"constexpr int HC_N = (\d+);", trunk).group(1) == str(
        us.HEAD_NCOLS)
    extra = int(re.search(r"HEADS_TILE_CHUNKS = TRUNK_CHUNKS \+ (\d+);",
                          trunk).group(1))
    assert extra == len(us.tail_schedule(us.HEADS_PARTS)) == 8
    assert [n for _, n, _ in us.tail_schedule(us.HEADS_PARTS)] == (
        [16] * 4 + [256] * 4)
    total = int(re.search(r"heads_blob_bytes\(\) == (\d+)", heads).group(1))
    assert total == 2 * us.pack_heads_blob(ff.pack_params(_field(0))).numel()
    assert "constexpr int HEAD_COL0 = WIDTH;" in heads
    assert us.HEAD_COL0 == 256
    assert "trunk_wg<IPE ? 3 : 4>(" in heads


def test_launch_heads_rejects_other_kernels():
    """launch_heads launches K11 or K12 and nothing else; the name is
    checked before any launch, so this runs without a card."""
    packed = ff.pack_params(_field(0))
    with pytest.raises(ValueError, match="unknown kernel"):
        ff.launch_heads(None, "field_forward_v3", packed,
                        torch.zeros(1, ff.IN_COLS))
