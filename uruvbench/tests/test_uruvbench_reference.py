"""The benchmark's plain reference, by hand and against the plain loop."""

import numpy as np
import pytest

from uruvbench.reference import (
    NOT_FOUND, OP_DELETE, OP_INSERT, OP_NOP, OP_RANGE, OP_SEARCH, TOMBSTONE,
    StoreMap, sequential_apply,
)

I, D, S, N, R = OP_INSERT, OP_DELETE, OP_SEARCH, OP_NOP, OP_RANGE


def test_codes_and_sentinels_are_the_ports():
    from repro_torch.core import ref

    assert (I, D, S, N, R) == (ref.OP_INSERT, ref.OP_DELETE, ref.OP_SEARCH,
                               ref.OP_NOP, ref.OP_RANGE)
    assert (NOT_FOUND, TOMBSTONE) == (ref.NOT_FOUND, ref.TOMBSTONE)


def test_one_plan_by_hand():
    m = StoreMap(100)
    res, ts, pages = m.apply([I, S, I, S, D, S, R, S, N],
                             [5, 5, 5, 5, 5, 5, 1, 7, 2**31 - 1],
                             [50, 0, 51, 0, 0, 0, 10, 0, 0])
    assert res.tolist() == [NOT_FOUND, 50, 50, 51, 51, NOT_FOUND, 0,
                            NOT_FOUND, NOT_FOUND]
    assert ts.tolist() == list(range(9)) and m.ts == 9
    assert [p.tolist() for p in pages] == [[]]
    res, ts, pages = m.apply([I, I, R, D, R, S], [3, 9, 1, 3, 1, 9],
                             [30, 90, 9, 0, 100, 0])
    assert res.tolist() == [NOT_FOUND, NOT_FOUND, 2, 30, 1, 90]
    assert ts.tolist() == list(range(9, 15))
    assert [p.tolist() for p in pages] == [[[3, 30], [9, 90]], [[9, 90]]]
    assert m.live_items().tolist() == [[9, 90]]


def test_a_key_written_many_times_in_one_plan():
    m = StoreMap(10)
    m.apply([I], [4], [1])
    res, _, _ = m.apply([S, I, D, S, I, I, S, D], [4] * 8,
                        [0, 2, 0, 0, 3, 4, 0, 0])
    assert res.tolist() == [1, 1, 2, NOT_FOUND, NOT_FOUND, 3, 4, 4]
    assert m.live_items().tolist() == []


@pytest.mark.parametrize("seed", range(4))
def test_apply_matches_the_plain_loop(seed):
    rng = np.random.default_rng(seed)
    m, state = StoreMap(64), {}
    for _ in range(6):
        n = int(rng.integers(1, 200))
        codes = rng.choice([I, D, S, N, R], n, p=[.3, .2, .35, .05, .1])
        keys = rng.integers(0, 65, n)
        vals = np.where(codes == R, keys + rng.integers(0, 20, n),
                        rng.integers(1, 1000, n))
        res, _, pages = m.apply(codes, keys, vals)
        want = sequential_apply(state, codes, keys, vals)
        assert res.tolist() == [w[0] for w in want]
        assert [p.tolist() for p in pages] == [
            [list(kv) for kv in w[1]] for w in want if w[1] is not None]
    assert m.live_items().tolist() == [list(kv) for kv in sorted(state.items())]
