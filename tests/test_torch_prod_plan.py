"""``pair_train_prod``'s schedule (``ops/dense_scorer.py:prod_plan``, which
``csrc/pair_train.cu:pair_prod_kernel`` walks): every (sequence, 64-label
tile, column tile) once, the two warpgroups of a block in turns, the rows
stored a sequence ``rows_per_seq`` (K1's padded chunk) with the last label
tile clipped there, and the widths the kernel refuses.  No card needed."""

from collections import Counter

import pytest

from protnote_tpu_torch.ops import dense_scorer as ds


@pytest.mark.parametrize("B,L,K,N,sms,rows", [
    (5, 301, 256, 512, 3, None),      # an odd pair, a ragged last label tile
    (2, 130, 128, 256, 8, None),      # one pair, more SMs than items
    (4, 300, 128, 384, 7, 384),       # 128-column tiles, K1's padded rows
    (1, 64, 128, 256, 132, None),     # one label tile, more SMs than items
    (32, 32102, 1024, 3072, 132, None),  # the dense training frame
    (32, 256, 1024, 3072, 132, 256),  # a serving chunk
])
def test_prod_plan_covers_every_tile_once_in_turns(B, L, K, N, sms, rows):
    plan = ds.prod_plan(B, L, K, N, sms, rows)
    Lz = L if rows is None else rows
    assert plan.block_n == (256 if N % 256 == 0 else 128)
    assert plan.grid == min(sms, plan.items)
    seen = Counter()
    stored = Counter()
    for block in range(plan.grid):
        tiles = plan.tiles(block)
        assert [t[0] for t in tiles] == [i % 2 for i in range(len(tiles))]  # in turns
        for w, b, l0, n_rows, n0 in tiles:
            assert b == 2 * (b // 2) + w
            if b >= B:
                assert n_rows == 0  # the odd pair's missing sequence: computed, not stored
                continue
            seen[(b, l0, n0)] += 1
            assert n_rows == min(ds.PROD_ROWS, Lz - l0) > 0
            stored[(b, n0)] += n_rows
    want = {(b, l0, n0) for b in range(B) for l0 in range(0, Lz, ds.PROD_ROWS)
            for n0 in range(0, N, plan.block_n)}
    assert set(seen) == want and set(seen.values()) == {1}
    assert set(stored.values()) == {Lz}
    last = max(l0 for _, l0, _ in want)
    assert Lz - last == (Lz % ds.PROD_ROWS or ds.PROD_ROWS)


def test_prod_plan_walks_label_tiles_outermost():
    """Consecutive items share a label tile until every pair and column
    tile of it is walked: the blocks in flight read one c and L_e tile."""
    plan = ds.prod_plan(6, 200, 256, 768, 4)
    firsts = [plan.item(t) for t in range(plan.items)]
    per_tile = plan.pairs * plan.tiles_n
    for t, (p, l0, n0) in enumerate(firsts):
        assert l0 == (t // per_tile) * ds.PROD_ROWS
        assert (p, n0) == ((t // plan.tiles_n) % plan.pairs, (t % plan.tiles_n) * plan.block_n)


@pytest.mark.parametrize("args", [(4, 100, 200, 512, 8, None), (4, 100, 256, 500, 8, None),
                                  (4, 100, 256, 512, 8, 99), (0, 100, 256, 512, 8, None),
                                  (4, 100, 256, 512, 0, None)])
def test_prod_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ds.prod_plan(*args)
