"""What the wrappers of the pair bodies decide on the host.

The CUDA kernels run only on a card; their grids, column splits, batch
slices, shared memory and scratch shapes are pure functions
(`general_pair_plan`, `exact_pair_plan`, `tri_plan`, `tile_pairs`,
`strip_plan`) that these tests hold to the kernels' contracts on the CPU: the shared memory fits a
block on an H100 and does not grow with L, every row and column is covered
exactly once, the column split is the same for a strip as for the whole
matrix (so B5' rows can be B5's bits; B2's warps own whole rows), every unordered
tile pair is met exactly once across strips, and both at-scale shapes — and
the exact body's three shapes (the pick at L = 512, a shard's 256 rows at
B = 20 and 10) — fill the card's 132 SMs.
"""

import pytest

from chromosome3d_tpu_torch.ops import _build
from chromosome3d_tpu_torch.ops.general_pair import (
    general_pair_plan,
    plan_cols,
    plan_rows,
)
from chromosome3d_tpu_torch.ops.pair_energy import exact_pair_plan
from chromosome3d_tpu_torch.ops.strip_tri import strip_plan, strip_tile
from chromosome3d_tpu_torch.ops.tri_energy import TILE, tile_pairs, tri_plan

BATCHES = (1, 10, 20)
LENGTHS = (8, 64, 512, 768, 5120, 8184)
SMS = 132


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_general_plan_shared_memory_fits_and_ignores_length(B, L):
    plan = general_pair_plan(B, L, L)
    assert 0 < plan["smem_bytes"] <= _build.SMEM_MAX == 232_448
    assert plan["smem_bytes"] == general_pair_plan(B, 64, 64)["smem_bytes"]
    # two blocks fit an SM's 228 KB with the 1 KB each the runtime reserves
    assert 2 * (plan["smem_bytes"] + 1024) <= 233_472
    assert plan["part_shape"] == (B, plan["nsplit"], 3, L)
    assert plan["e_part_shape"] == (B, plan["blocks"])


@pytest.mark.parametrize("strips", (1, 2, 4, 5))
@pytest.mark.parametrize("L", LENGTHS)
def test_general_plan_covers_every_row_and_column_once(L, strips):
    Lb = L // strips
    plan = general_pair_plan(20, L, Lb)
    rows = [i for g in range(plan["row_groups"]) for i in plan_rows(plan, g, Lb)]
    cols = [j for s in range(plan["nsplit"]) for j in plan_cols(plan, s, L)]
    assert rows == list(range(Lb))
    assert cols == list(range(L))          # once each, in ascending order
    assert plan["blocks"] == plan["row_groups"] * plan["nsplit"]
    for s in range(plan["nsplit"]):        # a split is whole 128-column chunks
        assert plan_cols(plan, s, L).start % plan["chunk"] == 0
        assert 0 < len(plan_cols(plan, s, L)) <= plan["cps"] * plan["chunk"]


@pytest.mark.parametrize("strips", (2, 4, 5))
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_general_plan_splits_columns_by_length_alone(B, L, strips):
    """B5' must sum a row's columns in B5's order: same splits, same chunks."""
    whole, strip = general_pair_plan(B, L, L), general_pair_plan(B, L, L // strips)
    for key in ("cps", "nsplit", "chunk", "bslice", "launches", "smem_bytes"):
        assert whole[key] == strip[key]


@pytest.mark.parametrize("B", (1, 2, 10, 20, 24, 25, 48, 49, 100, 1000))
def test_general_plan_batch_launches(B):
    plan = general_pair_plan(B, 512, 512)
    assert 1 <= plan["bslice"] <= 24
    assert plan["launches"] * plan["bslice"] >= B > (plan["launches"] - 1) * plan["bslice"]
    assert plan["smem_bytes"] <= general_pair_plan(24, 512, 512)["smem_bytes"]


@pytest.mark.parametrize("L", (5248, 6144, 8184))
def test_general_plan_groups_chunks_past_5120(L):
    plan = general_pair_plan(20, L, L)
    assert plan["cps"] == 2 and plan["nsplit"] == -(-(-(-L // 128)) // 2) <= 40


@pytest.mark.parametrize("B", (10, 20))
@pytest.mark.parametrize("Lb", (5120, 1280))
def test_at_scale_grids_fill_the_card(B, Lb):
    L = 5120
    assert general_pair_plan(B, L, Lb)["blocks"] >= 2 * SMS
    tri = tri_plan(B, L, L, TILE) if Lb == L else strip_plan(B, L, Lb, Lb)
    assert tri["blocks"] >= 2 * SMS


@pytest.mark.parametrize("tile", (64, 32, 16, 8))
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_tri_plan_shared_memory_fits_and_ignores_length(B, L, tile):
    plan = tri_plan(B, L, L, tile)
    assert 0 < plan["smem_bytes"] <= _build.SMEM_MAX
    assert 2 * (plan["smem_bytes"] + 1024) <= 233_472
    assert plan["smem_bytes"] == tri_plan(B, 64, 64, tile)["smem_bytes"]
    Tg = -(-L // tile)
    assert (plan["Tl"], plan["Tg"], plan["S"]) == (Tg, Tg, Tg // 2 + 1)
    assert plan["blocks"] == Tg * (Tg // 2 + 1)
    assert plan["part_shape"] == (B, 2 * plan["S"], 3, Tg * tile)   # padded to tiles
    assert plan["e_part_shape"] == (B, plan["blocks"])


@pytest.mark.parametrize("tile", (64, 32))
@pytest.mark.parametrize("B", (1, 2, 10, 11, 20, 23, 25, 100))
def test_tri_plan_slices_cover_the_batch(B, tile):
    """Both bodies (tile 64: the swapped-patch body; smaller tiles: the patch
    body) take up to 10 structures a slice, as few slices as cover B."""
    plan = tri_plan(B, 512, 512, tile)
    n = -(-B // plan["bslice"])
    assert 1 <= plan["bslice"] <= 10
    assert n * plan["bslice"] >= B > (n - 1) * plan["bslice"]
    assert n == -(-B // 10)
    # the shared memory is that of a slice, whatever B
    assert plan["smem_bytes"] <= tri_plan(10, 512, 512, tile)["smem_bytes"]


@pytest.mark.parametrize("Tg,strips", [
    (3, 1), (3, 3), (4, 1), (4, 2), (4, 4), (5, 1), (5, 5), (6, 2), (6, 3),
    (8, 2), (8, 4), (10, 2), (10, 5), (15, 5), (20, 4), (20, 5), (80, 4), (80, 5),
    (81, 1), (128, 2),
])
def test_tile_pairs_meet_every_unordered_pair_once(Tg, strips):
    """Odd and even tile counts: over the strips, each unordered pair of
    tiles (the diagonal included) is live in exactly one block."""
    Tl = Tg // strips
    seen = {}
    for r in range(strips):
        blocks = tile_pairs(Tl, Tg, r * Tl)
        assert len(blocks) == Tl * (Tg // 2 + 1)
        for ig, tj, sh, live in blocks:
            assert r * Tl <= ig < (r + 1) * Tl and tj == (ig + sh) % Tg
            if live:
                key = (min(ig, tj), max(ig, tj))
                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == Tg * (Tg + 1) // 2
    assert set(seen.values()) == {1}
    dead = sum(not b[3] for r in range(strips) for b in tile_pairs(Tl, Tg, r * Tl))
    assert dead == (Tg // 2 if Tg % 2 == 0 else 0)


@pytest.mark.parametrize("L,strips,tile", [
    (512, 2, 64), (512, 4, 64), (768, 2, 64), (768, 4, 64), (5120, 2, 64),
    (5120, 4, 64), (5120, 5, 64), (320, 5, 64), (96, 3, 32), (80, 5, 16), (96, 4, 8),
    (8184, 2, None), (100, 5, None),
])
@pytest.mark.parametrize("B", BATCHES)
def test_strip_plan(B, L, strips, tile):
    Lb = L // strips
    assert strip_tile(Lb) == tile
    if tile is None:
        with pytest.raises(ValueError):
            strip_plan(B, L, Lb, Lb)
        return
    for r in range(strips):
        plan = strip_plan(B, L, Lb, r * Lb)
        assert plan["tile"] == tile and plan["row0t"] == r * Lb // tile
        assert (plan["Tl"], plan["Tg"]) == (Lb // tile, L // tile)
        assert plan["blocks"] == plan["Tl"] * plan["S"]
        assert plan["part_shape"] == (B, 2 * plan["S"], 3, Lb)    # the compact layout
        assert plan["e_part_shape"] == (B, plan["blocks"])
        assert plan["smem_bytes"] <= _build.SMEM_MAX
    # the strips' row tiles partition the matrix's
    tiles = [ig for r in range(strips)
             for ig, _, sh, _ in tile_pairs(Lb // tile, L // tile, r * Lb // tile) if sh == 0]
    assert tiles == list(range(L // tile))


@pytest.mark.parametrize("row_start", (-64, 32, 4096 + 64))
def test_strip_plan_refuses_misaligned_strips(row_start):
    with pytest.raises(ValueError):
        strip_plan(20, 5120, 1280, row_start)


@pytest.mark.parametrize("strips", (1, 2, 4, 5))
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("B", BATCHES + (25, 60))
def test_exact_plan_covers_every_row_column_and_structure_once(B, L, strips):
    """A block a (row group, structure); a warp's lanes stride all L columns
    of its row (lane l takes l, l + 32, ...), whatever the strip."""
    Lb = max(1, L // strips)
    plan = exact_pair_plan(B, L, Lb)
    rows = [i for g in range(plan["row_groups"]) for i in plan_rows(plan, g, Lb)]
    cols = sorted(j for lane in range(32) for j in range(lane, L, 32))
    assert rows == list(range(Lb))
    assert cols == list(range(L))
    assert plan["blocks"] == plan["row_groups"] * B
    assert plan["e_part_shape"] == (B, plan["row_groups"])


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("B", BATCHES + (25, 60, 1000))
def test_exact_plan_shared_memory_fits(B, L):
    """The last block stages the block energies in its 8 KB of static shared
    memory when they fit, and reads them through L2 otherwise; at the
    paths' shapes they fit."""
    plan = exact_pair_plan(B, L, L)
    assert plan["staged"] == (B * plan["row_groups"] <= 2048)
    assert 4 * 2048 <= _build.SMEM_MAX
    if B <= 20 and L <= 512:
        assert plan["staged"]


@pytest.mark.parametrize("B,L,Lb", [(20, 512, 512), (20, 512, 256), (10, 512, 256)])
def test_exact_plan_fills_the_card(B, L, Lb):
    """The pick's shape and a shard step's (before and after the pick)."""
    plan = exact_pair_plan(B, L, Lb)
    assert plan["blocks"] >= SMS
