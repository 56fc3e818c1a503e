"""Kernel B's resident main kernel (csrc/fusion_attention_bf16.cu,
edge_attention_bf16_persistent): its schedule and its layout, through their
Python mirrors, on the CPU.

The kernel is persistent: min(tiles, multiprocessors) blocks, block k taking
the tiles of 8 columns k, k + grid, ...; a ring of stages holds each tile's
chunks of 8 sources, in order, and two consumer groups take alternate
chunks, each refilling the stages it frees; the 8 consumer warps' softmax states are merged
in a fixed order. `resident_schedule` and `resident_column_plan` mirror those
loops. The tests walk them over B in {1, 3, 8, 32, 128} and N in {1, 7, 9,
33, 129} (tiles inside one scene, across two, across up to eight, ragged
last tiles): every column is computed exactly once, a column's sources are
split among the warps and merged in an order that depends on N alone (never
on B or the grid: the batch-invariance the card checks to the bit), and the
ring's mbarrier protocol (each stage refilled by the group that frees it),
simulated step by step, never stalls and never lets a waiter see a phase
two ahead of the one it waits for. The layout
mirror `kernel_smem` is held over the whole resident domain. The kernel
itself runs only on the card (tests/test_torch_fusion_attention.py's
cuda-marked test_cuda_bf16_kernel_matches_plain, at these B and N)."""

import itertools

import pytest

from mind_tpu_torch.ops import fusion_attention as tfa

BATCHES = (1, 3, 8, 32, 128)
NODES = (1, 7, 9, 33, 129)
# multiprocessors: the H100's 132, and fewer, so that blocks take many tiles
GRIDS = (132, 7, 1)
RESIDENT = [(d, e, h) for d in range(16, 129, 16) for e in range(16, 129, 16)
            for h in range(1, 17) if d % h == 0 and (d // h) % 8 == 0]


@pytest.mark.parametrize("batch,n", list(itertools.product(BATCHES, NODES)))
def test_schedule_covers_every_column_once(batch, n):
    """Every (scene, target) column of the call lies in exactly one tile of
    one block, each block walks its tiles in order from its own index, and
    a tile's chunks go through the ring in order, alternating groups."""
    ntiles = -(-batch * n // tfa.B_TILE_COLS)
    for sms in GRIDS:
        sched = tfa.resident_schedule(batch, n, sms=sms, stages=2)
        grid = min(ntiles, sms)
        assert sorted(t.tile for t in sched) == list(range(ntiles))
        assert {t.block for t in sched} == set(range(grid))
        cols = [c for t in sched for c in t.columns]
        assert sorted(cols) == [(b, j) for b in range(batch) for j in range(n)]
        for block in range(grid):
            mine = [t for t in sched if t.block == block]
            assert [t.tile for t in mine] == list(range(block, ntiles, grid))
            uses = [(stage, use) for t in mine for (_, _, stage, use) in t.chunks]
            assert uses == [(k % 2, k // 2) for k in range(len(uses))]
        for t in sched:
            assert [(i0, grp) for i0, grp, _, _ in t.chunks] == \
                [(8 * ch, ch % 2) for ch in range(-(-n // 8))]
            # a tile that straddles scenes keeps its 8 consecutive columns
            assert len(t.columns) == min(8, batch * n - 8 * t.tile)


@pytest.mark.parametrize("n", NODES)
def test_column_plan_depends_on_n_alone(n):
    """A column's sources are split among the 8 consumer warps by its chunks
    alone: every source exactly once, warp 4 g + w taking sources 8 ch + 2 w
    and + 1 of the chunks ch of group g; the same plan for every column of
    every batch and grid, and the merge order fixed."""
    split, merge = tfa.resident_column_plan(n)
    assert sorted(i for w in split for i in w) == list(range(n))
    assert merge == ((0, 2, 4, 6), (1, 3, 5, 7))
    for w8, sources in enumerate(split):
        grp, warp = divmod(w8, 4)
        assert all((i // 8) % 2 == grp and (i % 8) // 2 == warp for i in sources)
        assert list(sources) == sorted(sources)
    for batch, sms in itertools.product(BATCHES, GRIDS):
        for t in tfa.resident_schedule(batch, n, sms=sms):
            # every column of a tile gets the chunks (first source, group)
            # the plan is made of, whatever tile, block or batch it is in
            got = [[] for _ in range(8)]
            for i0, grp, _, _ in t.chunks:
                for warp in range(4):
                    got[4 * grp + warp] += [i for i in (i0 + 2 * warp, i0 + 2 * warp + 1)
                                            if i < n]
            assert tuple(map(tuple, got)) == split


def simulate_ring(batch, n, sms, stages):
    """Run a block's two consumer groups as the kernel orders them, one step
    at a time, against the mbarriers' phase counts. The copies: the first
    `stages` chunks and the first tile's tp and q rows at the start, chunk
    t + stages when the group that took chunk t frees its stage, a tile's
    rows after the previous tile's merge. A group: for each of its chunks,
    wait for the chunk (and, at its first, the tile's rows), then free the
    stage; then the merge, which needs both groups. Returns the steps taken;
    raises where neither group can move."""
    sched = tfa.resident_schedule(batch, n, sms=sms, stages=stages)
    steps = 0
    for block in {t.block for t in sched}:
        tiles = [t for t in sched if t.block == block]
        nch = len(tiles[0].chunks)
        total = len(tiles) * nch
        cons = {grp: [] for grp in (0, 1)}
        for kl in range(len(tiles)):
            for grp in (0, 1):
                for k, ch in enumerate(range(grp, nch, 2)):
                    cons[grp].append(("chunk", kl * nch + ch, kl, k == 0))
                cons[grp].append(("merge", kl))
        loads = [0] * stages           # completed phases of full[s]
        for t in range(min(stages, total)):
            loads[t % stages] += 1
        tile_loads, merged = 1, set()  # completed phases of tile_full; merged tiles
        at_merge = {0: None, 1: None}
        cc = {0: 0, 1: 0}
        while any(cc[g] < len(cons[g]) for g in cons):
            moved = False
            for grp in (0, 1):
                if cc[grp] == len(cons[grp]):
                    continue
                step = cons[grp][cc[grp]]
                if step[0] == "chunk":
                    _, t, kl, first = step
                    # wait on full[t % stages] for the phase of parity
                    # (t // stages) & 1: it must be that use's, not one ahead
                    if loads[t % stages] <= t // stages or (first and tile_loads <= kl):
                        continue
                    assert loads[t % stages] == t // stages + 1
                    assert not first or tile_loads == kl + 1
                    if t + stages < total:   # the freed stage takes chunk t + stages
                        loads[t % stages] += 1
                    cc[grp], moved = cc[grp] + 1, True
                else:
                    at_merge[grp] = step[1]
                    if at_merge[1 - grp] == step[1] or step[1] in merged:
                        if step[1] not in merged and step[1] + 1 < len(tiles):
                            tile_loads += 1   # the next tile's rows, after the merge
                        merged.add(step[1])
                        cc[grp], moved = cc[grp] + 1, True
            steps += 1
            if not moved:
                raise AssertionError(f"the ring stalls: block {block}, groups at "
                                     f"{[cons[g][cc[g]] if cc[g] < len(cons[g]) else 'end' for g in cons]}")
    return steps


@pytest.mark.parametrize("batch,n", list(itertools.product(BATCHES, NODES)))
def test_ring_never_stalls(batch, n):
    """The two consumer groups of every block, refilling the stages they
    free, run to their ends with 2, 3 or 4 stages, on the H100's grid and on
    a grid of 7 blocks (many tiles a block), each wait seeing the phase it
    waits for."""
    for stages, sms in itertools.product((2, 3, 4), (132, 7)):
        assert simulate_ring(batch, n, sms, stages) > 0


def test_layout_mirror_over_the_resident_domain():
    """Every resident shape's persistent kernel fits the card's shared
    memory with 2 to 4 stages, one block a multiprocessor, 64-row chunks of
    8-column tiles and no static shared memory; the main path's 128 / 128 /
    8 and 128 / 128 / 16 take 2 stages in 226,336 B, narrower shapes more."""
    for d, e, h in RESIDENT:
        assert tfa.kernel_layout(d, e, h) == "resident"
        m = tfa.kernel_smem("bfloat16", d, e, h)
        assert m.dynamic <= tfa.SMEM_BUDGET, (d, e, h)
        assert m.tile[:2] == (64, 8) and 2 <= m.tile[2] <= 4 and m.blocks == 1
        assert m.tj == tfa.B_TILE_COLS and m.static[1] == 0
        assert (m.dynamic, m.tile[2]) == tfa._layout_b(d, e, h)
    for shape in ((128, 128, 8), (128, 128, 16)):
        m = tfa.kernel_smem("bfloat16", *shape)
        assert (m.dynamic, m.tile) == (226336, (64, 8, 2))
    assert tfa.kernel_smem("bfloat16", 16, 16, 2).tile[2] == 4
    # kernel A's resident layout reports no ring
    a = tfa.kernel_smem("float32", 128, 128, 8)
    assert (a.tile, a.blocks) == ((), 0)
