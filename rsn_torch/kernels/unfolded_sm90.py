"""The weights of K14 (`field_forward_v3u` / `v3i`) and K15
(`field_forward_v3L` / `v3F`) pre-packed for their Hopper kernels' weight
ring (rsn_torch/csrc/unfolded_sm90.cuh), and of K11 (`field_forward_v2`)
and K12 (`field_forward`) for theirs (rsn_torch/csrc/heads_sm90.cuh); the
plan by which the two consumer warpgroups of K14 / K15 take turns on the
ring, with a plain simulation of it.

The blob is trunk_sm90.pack_blob's 32 trunk chunks, then the unfolded
tail's 12 chunks of 64 k-rows each, in the order the kernels use them: the
head columns wh[:, 256:272] (N = 16), the bottleneck wh[:, 0:256] (N =
256), the mid seed w_emb (N = 128), each in wgmma's K-major, 128-byte
swizzled B layout (trunk_sm90.swizzle_chunk).  The head columns 267..271
and the rows 99..127 of the IPE's chunks are zero.  K11's and K12's blob
(pack_heads_blob) is its first 40 chunks, cut before the mid seed: the
same packer on pack_params' 18 tensors.  Each is built once per packed
tuple (pack_params_v3 and pack_params return a PackedOperands that keeps
it under its own format: experiments.interleave.ring_blob,
field_forward.heads_blob), never per call.

The ring has STAGES stages, and each of a tile's 44 chunks is read by both
consumers: a stage is refilled only once both have released it.  So a
consumer can run at most STAGES - 1 chunks ahead of the other.  The
schedules (unfolded_sm90.cuh) order the consumers' products:
  v3u   in step: no order but the ring's;
  v3i   consumer 1 starts once consumer 0 has issued its first TURN_LAG
        chunks; then no order but the ring's;
  v3L   turns chunk by chunk through the trunk: consumer 1 issues chunk c
        once consumer 0 has, consumer 0 issues chunk c once consumer 1 has
        issued chunk c - TURN_LAG; the tail in step;
  v3F   the turns through the tail's chunks too.
consumer_program and simulate_ring replay a plan on mbarriers as the
hardware keeps them (a wait reads a phase parity, so a barrier two phases
ahead of its waiter would be misread) and raise RingDeadlock where a plan
waits on itself: a turn handed over only after a whole layer does.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import torch

from rsn_torch.kernels import trunk_sm90 as ts
from rsn_torch.models.field import TRUNK_WIDTH

BF16 = torch.bfloat16
MID = ts.MID
STAGES = 3                  # trunk_sm90.cuh's ring
TURN_LAG = STAGES - 1       # unfolded_sm90.cuh's
TURN_SLOTS = TURN_LAG + 1   # turn mbarriers per consumer
HEAD_COL0, HEAD_NCOLS = 256, 16   # wh's head columns 256..271 (11 live)
# the unfolded tail's parts in ring order: (name, N)
TAIL_PARTS = (("head_cols", HEAD_NCOLS), ("bottleneck", TRUNK_WIDTH),
              ("mid_seed", MID))
HEADS_PARTS = TAIL_PARTS[:2]   # K11 / K12: the tail cut before the mid seed
TRUNK_CHUNKS = len(ts.trunk_schedule())
TAIL_CHUNKS = len(TAIL_PARTS) * TRUNK_WIDTH // ts.CHUNK_K
VARIANTS = ("v3u", "v3i", "v3L", "v3F")


def tail_schedule(parts=TAIL_PARTS) -> List[Tuple[str, int, int]]:
    """The tail's chunks of `parts` in the kernels' order: (part, N, first
    k-row)."""
    return [(part, n, k0) for part, n in parts
            for k0 in range(0, TRUNK_WIDTH, ts.CHUNK_K)]


@torch.no_grad()
def pack_unfolded_blob(packed_v3, parts=TAIL_PARTS) -> torch.Tensor:
    """The ring's chunks of pack_params_v3's 22 operands (the trunk's 32,
    then the tail's 12), or with parts=HEADS_PARTS of pack_params' 18 (the
    trunk's 32, then 8) -> 1-D bf16, contiguous."""
    wh = packed_v3[16]
    mats = {"head_cols": wh[:, HEAD_COL0:HEAD_COL0 + HEAD_NCOLS],
            "bottleneck": wh[:, :TRUNK_WIDTH]}
    if "mid_seed" in dict(parts):
        mats["mid_seed"] = packed_v3[18]
    return torch.cat([ts.pack_blob(packed_v3[:8])] + [
        ts.swizzle_chunk(mats[part][k0:k0 + ts.CHUNK_K])
        for part, _, k0 in tail_schedule(parts)]).contiguous()


def pack_heads_blob(packed) -> torch.Tensor:
    """K11's and K12's ring blob: pack_params' 18 operands as the first 40
    chunks of the unfolded blob -> 1-D bf16, contiguous."""
    return pack_unfolded_blob(packed, HEADS_PARTS)


def unpack_unfolded_blob(blob: torch.Tensor, parts=TAIL_PARTS):
    """pack_unfolded_blob's inverse -> (w0..w7, {part: (256, N) bf16})."""
    trunk_elems = TRUNK_CHUNKS * ts.CHUNK_K * TRUNK_WIDTH
    want = trunk_elems + ts.CHUNK_K * sum(n for _, n, _ in
                                          tail_schedule(parts))
    if blob.numel() != want:
        raise ValueError(f"unfolded blob of {blob.numel()} values, expected "
                         f"{want}")
    ws, _ = ts.unpack_blob(blob[:trunk_elems])
    off, rows = trunk_elems, {}
    for part, n, _ in tail_schedule(parts):
        rows.setdefault(part, []).append(
            ts.unswizzle_chunk(blob[off:off + n * ts.CHUNK_K], n))
        off += n * ts.CHUNK_K
    return ws, {part: torch.cat(r) for part, r in rows.items()}


# ---- the consumers' plan on the ring ---------------------------------------

class RingDeadlock(RuntimeError):
    """A plan of the ring that waits on itself, or reads an mbarrier two
    phases ahead of the phase it waits for."""


def tile_groups(variant: str) -> List[Tuple[int, bool]]:
    """One tile's mma_chunks calls of a consumer: (chunks, whether they take
    turns): the trunk's 8 layers, then the head columns, the bottleneck,
    the mid seed."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    per_layer: Dict[int, int] = {}
    for layer, _, _ in ts.trunk_schedule():
        per_layer[layer] = per_layer.get(layer, 0) + 1
    trunk_turns = variant in ("v3L", "v3F")
    return ([(per_layer[layer], trunk_turns) for layer in sorted(per_layer)]
            + [(TAIL_CHUNKS // len(TAIL_PARTS), variant == "v3F")]
            * len(TAIL_PARTS))


def consumer_program(variant: str, wg: int, tiles: int, stages: int = STAGES,
                     lag: int = TURN_LAG, unit: str = "chunk"):
    """Consumer warpgroup wg's events on the ring over `tiles` tiles, in the
    order mma_chunks runs them: per chunk the turn's wait, the stage's full
    barrier, the turn's signal once the products are issued, the release of
    the chunk before (after the wait for its products); the group's last
    release.  unit "layer": the turns around a whole mma_chunks call (a
    layer) instead of each chunk, as the first design's PingPong."""
    if unit not in ("chunk", "layer"):
        raise ValueError(f"unknown unit {unit!r}")
    events, q, c = [], 0, 0
    for _ in range(tiles):
        for n, turned in tile_groups(variant):
            for j in range(n):
                if turned and (unit == "chunk" or j == 0):
                    events.append(("turn_wait", wg, c))
                if variant == "v3i" and wg == 1 and q == 0:
                    events.append(("start_wait",))
                events.append(("full_wait", q % stages, q // stages))
                if turned and (unit == "chunk" or j == n - 1):
                    events.append(("turn_arrive", wg, c))
                    c += 1
                if variant == "v3i" and wg == 0 and q == lag - 1:
                    events.append(("start_arrive",))
                if j > 0:
                    events.append(("release", (q - 1) % stages))
                q += 1
            events.append(("release", (q - 1) % stages))
    return events


def producer_program(variant: str, tiles: int, stages: int = STAGES):
    """The producer thread's events: per chunk the stage's empty barrier,
    then the copy that completes its full barrier."""
    chunks = tiles * sum(n for n, _ in tile_groups(variant))
    events = []
    for q in range(chunks):
        events += [("empty_wait", q % stages, q // stages),
                   ("fill", q % stages)]
    return events


def simulate_ring(variant: str, tiles: int = 3, stages: int = STAGES,
                  lag: int = TURN_LAG, unit: str = "chunk",
                  order: Sequence[int] = (0, 1, 2), seed=None) -> int:
    """Replays the producer (actor 0) and the two consumers (actors 1, 2) on
    the ring's and the turns' mbarriers.  Each step runs one event of an
    actor whose next event can run: the first in `order`, or one drawn at
    random with `seed`.  A wait on phase k of a barrier passes once k + 1
    phases have completed; it raises if k + 2 have (a parity wait would
    misread it).  -> the number of events run; raises RingDeadlock when no
    actor can go on before all are done."""
    progs = [producer_program(variant, tiles, stages)] + [
        consumer_program(variant, wg, tiles, stages, lag, unit)
        for wg in (0, 1)]
    slots = lag + 1
    full = [0] * stages        # completed phases
    empty_arrivals = [0] * stages
    turns = [[0] * slots for _ in range(2)]
    started = [False]
    ptr = [0, 0, 0]
    rng = random.Random(seed) if seed is not None else None

    def done_phases(have: int, want: int, what: str) -> bool:
        if have >= want + 2:
            raise RingDeadlock(f"{what}: phase {want} read with {have} "
                               "complete")
        return have >= want + 1

    def ready(ev) -> bool:
        kind = ev[0]
        if kind == "full_wait":
            return done_phases(full[ev[1]], ev[2], f"full[{ev[1]}]")
        if kind == "empty_wait":
            # use k of a stage needs k releases (phase k - 1 of empty)
            return ev[2] == 0 or done_phases(empty_arrivals[ev[1]] // 2,
                                             ev[2] - 1, f"empty[{ev[1]}]")
        if kind == "turn_wait":
            wg, c = ev[1], ev[2]
            if wg == 1:
                return done_phases(turns[0][c % slots], c // slots,
                                   f"turn of consumer 0, chunk {c}")
            if c < lag:
                return True
            j = c - lag
            return done_phases(turns[1][j % slots], j // slots,
                               f"turn of consumer 1, chunk {j}")
        if kind == "start_wait":
            return started[0]
        return True

    def run(ev) -> None:
        kind = ev[0]
        if kind == "fill":
            full[ev[1]] += 1
        elif kind == "release":
            empty_arrivals[ev[1]] += 1
        elif kind == "turn_arrive":
            turns[ev[1]][ev[2] % slots] += 1
        elif kind == "start_arrive":
            started[0] = True

    steps = 0
    while True:
        live = [a for a in order
                if ptr[a] < len(progs[a]) and ready(progs[a][ptr[a]])]
        if not live:
            break
        a = rng.choice(live) if rng is not None else live[0]
        run(progs[a][ptr[a]])
        ptr[a] += 1
        steps += 1
    stuck = [(a, progs[a][ptr[a]]) for a in range(3) if ptr[a] < len(progs[a])]
    if stuck:
        raise RingDeadlock(f"{variant} ({unit} turns, {stages} stages): "
                           f"waits on itself at {stuck}")
    return steps
