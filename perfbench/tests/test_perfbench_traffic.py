"""Every seed offers the same work: the same lengths and tokens a cycle."""
import collections
import itertools
import json

import numpy as np
import pytest

from conftest import REPO
from perfbench import generator

MIX = json.loads((REPO / "perfbench" / "traffic" /
                  "score_long.json").read_text())
SEEDS = [0, 1, 2**31 + 7, 2**33 + 5, -3]


def cycles(seed, n):
    it = generator.batches(MIX, 32001, seed)
    per = len(generator.cycle_lengths(MIX))
    return [list(itertools.islice(it, per)) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_cycle_offers_the_same_work(seed):
    want = collections.Counter(generator.cycle_lengths(MIX))
    assert want == {2048: 4, 4096: 2, 8192: 1}
    for c, cyc in enumerate(cycles(seed, 3)):
        assert collections.Counter(b.length for b in cyc) == want
        assert sum(b.n_tokens for b in cyc) == 4 * (4 * 2048 + 2 * 4096
                                                    + 8192)
        for b in cyc:
            assert b.cycle == c and b.tokens.shape == (4, b.length)
            assert b.tokens.dtype == np.int32
            assert 0 <= b.tokens.min() and b.tokens.max() < 32001


def test_seed_orders_and_draws_but_repeats():
    a, b = cycles(11, 4), cycles(11, 4)
    assert all(np.array_equal(x.tokens, y.tokens)
               for ca, cb in zip(a, b) for x, y in zip(ca, cb))
    orders = {tuple(tuple(x.length for x in cyc) for cyc in cycles(s, 4))
              for s in range(6)}
    assert len(orders) > 1
    assert not np.array_equal(cycles(11, 1)[0][0].tokens,
                              cycles(12, 1)[0][0].tokens)


def test_start_cycle_continues_the_order():
    it = generator.batches(MIX, 100, 5, first_cycle=2)
    per = len(generator.cycle_lengths(MIX))
    later = list(itertools.islice(it, per))
    assert [b.index for b in later] == list(range(2 * per, 3 * per))
    assert [b.length for b in later] == [b.length for b in cycles(5, 3)[2]]


def test_warmup_takes_each_length_once_a_client():
    warm = generator.warmup_batches(MIX, 100, 9)
    assert [b.length for b in warm] == [2048, 2048, 4096, 4096, 8192, 8192]
    assert len({b.tokens.tobytes() for b in warm}) == len(warm)


@pytest.mark.parametrize("bad", [dict(kind="open"), dict(batch=0),
                                 dict(batches_per_cycle=[4, 2])])
def test_bad_mix_is_refused(bad):
    with pytest.raises(ValueError):
        generator.check_mix(dict(MIX, **bad))
