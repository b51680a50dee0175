"""K14's and K15's Hopper kernels (rsn_torch/csrc/unfolded_sm90.cuh) on the
CPU: their weight blob (rsn_torch/kernels/unfolded_sm90.py) round-trips to
pack_params_v3's tensors exactly, a plain forward that reads every weight
back from the blob equals unfolded_forward_plain exactly, the blob's chunk
order and sizes are the header's, and each schedule's plan of the two
consumers on the 3-stage ring (stages, arrivals, turns) never waits on
itself, while turns handed over only after a whole layer do.  The kernels
themselves run only on a card (tests/test_torch_cuda.py)."""
import os
import re

import numpy as np
import pytest
import torch

from rsn_torch.experiments import interleave
from rsn_torch.kernels import field_forward as ff
from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.kernels import unfolded_sm90 as us
from rsn_torch.models.field import Field

CSRC = os.path.join(os.path.dirname(us.__file__), "..", "csrc")


def _field(seed: int) -> Field:
    return Field(torch.Generator().manual_seed(seed)).eval()


def _rows(R: int, S: int, seed: int, field: Field):
    rng = np.random.default_rng(seed)
    n = R * S
    mc = np.zeros((n, ff.IN_COLS), np.float32)
    mc[:, :3] = rng.uniform(-1.8, 1.8, (n, 3))
    mc[:, 3:6] = rng.uniform(0.0, 3e-3, (n, 3))
    mc[: min(n, 4), 3:6] = 0.0  # undamped top octaves
    dirs = rng.normal(size=(R, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (torch.from_numpy(mc),
            ff.mid_g_bands(field, torch.from_numpy(dirs)))


@pytest.mark.parametrize("seed", [0, 3])
def test_unfolded_blob_round_trips(seed):
    """unpack(pack(pack_params_v3)) gives back w0..w7, wh's bottleneck and
    head columns and w_emb bit for bit; the blob is the trunk's 32 chunks
    of 64 x 256 then 4 x (64 x 16), 4 x (64 x 256), 4 x (64 x 128)."""
    p3 = ff.pack_params_v3(_field(seed))
    blob = us.pack_unfolded_blob(p3)
    assert blob.dtype == torch.bfloat16 and blob.is_contiguous()
    assert blob.numel() == 64 * (32 * 256 + 4 * (16 + 256 + 128))
    ws, tail = us.unpack_unfolded_blob(blob)
    for got, want in zip(ws, p3[:8]):
        assert torch.equal(got, want)
    assert torch.equal(tail["head_cols"], p3[16][:, 256:272])
    assert torch.equal(tail["bottleneck"], p3[16][:, :256])
    assert torch.equal(tail["mid_seed"], p3[18])
    # the head columns past the 11 live ones are zero in the operands
    assert torch.all(p3[16][:, 267:] == 0)
    with pytest.raises(ValueError, match="unfolded blob"):
        us.unpack_unfolded_blob(blob[:-64])


def test_ring_blob_is_kept_per_packed_tuple():
    """pack_params_v3's tuple keeps its blob from the first use on (one
    pack per tuple, not per call), under its own format, apart from K1's /
    K2's; a plain sequence gets a fresh one."""
    p3 = ff.pack_params_v3(_field(1))
    first = interleave.ring_blob(p3)
    assert interleave.ring_blob(p3) is first
    assert p3.blobs == {"unfolded": first}
    assert torch.equal(first, us.pack_unfolded_blob(p3))
    plain = tuple(p3)
    assert interleave.ring_blob(plain) is not interleave.ring_blob(plain)
    assert torch.equal(interleave.ring_blob(plain), first)


def unfolded_blob_plain(blob: torch.Tensor, packed_v3, x: torch.Tensor,
                        g_bands: torch.Tensor,
                        samples_per_ray: int) -> torch.Tensor:
    """unfolded_forward_plain with every weight read back from the kernels'
    blob (unfolded_sm90.pack_unfolded_blob; the biases and w_out from
    packed_v3): (N, 128) bf16."""
    ws, tail = us.unpack_unfolded_blob(blob)
    wh = torch.zeros_like(packed_v3[16])
    wh[:, :us.HEAD_COL0] = tail["bottleneck"]
    wh[:, us.HEAD_COL0:us.HEAD_COL0 + us.HEAD_NCOLS] = tail["head_cols"]
    return interleave.unfolded_forward_plain(
        tuple(ws) + tuple(packed_v3[8:16]) + (wh, packed_v3[17],
                                              tail["mid_seed"])
        + tuple(packed_v3[19:]), x, g_bands, samples_per_ray)


@pytest.mark.parametrize("seed,R,S", [(0, 1, 1), (1, 3, 7), (3, 5, 29)])
@pytest.mark.parametrize("ipe", ["exact", "poly"])
def test_blob_plain_equals_unfolded_forward_plain(seed, R, S, ipe):
    """The forward read from the blob (every weight as the kernels stream
    it) equals unfolded_forward_plain on pack_params_v3's tensors exactly,
    on either IPE (v3u / v3i: exact; v3L / v3F: the polynomial one)."""
    field = _field(seed)
    p3 = ff.pack_params_v3(field)
    mc, g = _rows(R, S, seed, field)
    x = ff.ipe_enc(mc) if ipe == "exact" else ff.ipe_x(mc)
    got = unfolded_blob_plain(us.pack_unfolded_blob(p3), p3, x, g, S)
    want = interleave.unfolded_forward_plain(p3, x, g, S)
    assert got.shape == (R * S, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.all(got[:, 14:] == 0)


def test_blob_order_is_the_headers():
    """The chunk sizes unfolded_sm90.cuh streams (u_chunk_bytes: 32 trunk
    chunks of 32 KB, then 2 KB, 32 KB, 16 KB chunks of the tail) are the
    packer's, and so is the blob's total; STAGES and TURN_LAG are the
    headers'."""
    header = open(os.path.join(CSRC, "unfolded_sm90.cuh")).read()
    trunk = open(os.path.join(CSRC, "trunk_sm90.cuh")).read()
    assert re.search(r"constexpr int STAGES = (\d+);", trunk).group(1) == str(
        us.STAGES)
    assert "constexpr int TURN_LAG = STAGES - 1;" in header
    assert us.TURN_LAG == us.STAGES - 1 and us.TURN_SLOTS == us.TURN_LAG + 1
    total = int(re.search(r"u_blob_bytes\(\) == (\d+)", header).group(1))
    sizes = [ts.CHUNK_K * 256 * 2] * us.TRUNK_CHUNKS + [
        n * ts.CHUNK_K * 2 for _, n, _ in us.tail_schedule()]
    assert sum(sizes) == total == 2 * us.pack_unfolded_blob(
        ff.pack_params_v3(_field(0))).numel()
    assert [n for _, n, _ in us.tail_schedule()] == [16] * 4 + [256] * 4 + [
        128] * 4
    assert f"U_TAIL_CHUNKS = {us.TAIL_CHUNKS};" in header


@pytest.mark.parametrize("variant", us.VARIANTS)
@pytest.mark.parametrize("policy", ["producer first", "consumer 1 first",
                                    "random 0", "random 1", "random 2"])
def test_ring_plan_never_waits_on_itself(variant, policy):
    """Each schedule's plan (the producer's empty waits and copies, the two
    consumers' full waits, releases and turns) runs to its end on a 3-stage
    ring over 3 tiles, whichever actor runs first, and no wait reads a
    barrier two phases ahead."""
    if policy.startswith("random"):
        kw = dict(seed=int(policy[-1]))
    else:
        kw = dict(order=(0, 1, 2) if policy == "producer first" else
                  (2, 1, 0))
    steps = us.simulate_ring(variant, tiles=3, stages=3, **kw)
    chunks = 3 * (us.TRUNK_CHUNKS + us.TAIL_CHUNKS)
    turns = {"v3u": 0, "v3i": 0, "v3L": 3 * us.TRUNK_CHUNKS,
             "v3F": chunks}[variant]
    starts = 2 if variant == "v3i" else 0
    # producer: 2 a chunk; each consumer: a full wait and a release a chunk,
    # a wait and a signal a turned chunk
    assert steps == 2 * chunks + 2 * (2 * chunks + 2 * turns) + starts


@pytest.mark.parametrize("lag", [1, 2])
@pytest.mark.parametrize("variant", ["v3L", "v3F"])
def test_turns_hold_for_each_lag_the_ring_allows(variant, lag):
    """The turns at a lag of 1 (strict alternation) and 2 (STAGES - 1) both
    run through; the kernel's static_assert allows exactly these."""
    assert us.simulate_ring(variant, stages=3, lag=lag, seed=lag) > 0


@pytest.mark.parametrize("variant", ["v3L", "v3F"])
def test_turns_after_a_whole_layer_wait_on_themselves(variant):
    """Handing the turn over only after a whole layer's products (the
    first design's PingPong, on the shared ring) deadlocks with 3 stages:
    consumer 0's fourth chunk needs a stage that consumer 1, waiting for
    the turn, never releases."""
    with pytest.raises(us.RingDeadlock, match="waits on itself"):
        us.simulate_ring(variant, stages=3, unit="layer")
    with pytest.raises(us.RingDeadlock, match="waits on itself"):
        us.simulate_ring(variant, stages=3, unit="layer", seed=5)


def test_plan_rejects_unknown_variants():
    with pytest.raises(ValueError, match="variant"):
        us.tile_groups("v3x")
    with pytest.raises(ValueError, match="unit"):
        us.consumer_program("v3L", 0, 1, unit="tile")
