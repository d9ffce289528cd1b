"""Each traffic mix is a function of (seed, round) alone."""

import numpy as np
import pytest

from portbench import spec
from portbench.generator import Traffic

MIXES = [("uniform", 10000), ("hot_resources", 10000), ("hot_keys", 1000)]


@pytest.mark.parametrize("mix,resources", MIXES)
def test_mix_is_deterministic_for_a_seed(mix, resources):
    m = spec.load_traffic(mix)
    a = Traffic(m, resources, 2**31 + 12345, width=512)
    b = Traffic(m, resources, 2**31 + 12345, width=512)
    c = Traffic(m, resources, 2**31 + 12346, width=512)
    for r in (0, 3, 3, 1000):
        for x, y in zip(a.entries(r), b.entries(r)):
            assert np.array_equal(x, y)
        for x, y in zip(a.exits(r), b.exits(r)):
            assert np.array_equal(x, y)
    assert not np.array_equal(a.entries(5).resource, c.entries(5).resource)
    e = a.entries(7)
    assert e.resource.min() >= 0 and e.resource.max() < resources
    assert e.key.min() >= 1 and e.key.max() < 2**31
    x = a.exits(7)
    lo, hi = m["rt_ms"]
    assert x.rt_ms.min() >= lo and x.rt_ms.max() <= hi


def test_unique_keys_never_repeat():
    t = Traffic(spec.load_traffic("uniform"), 10000, 99, width=8192)
    keys = np.concatenate([t.entries(r).key for r in range(64)])
    assert np.unique(keys).size == keys.size


def test_hot_keys_follow_the_zipf_ranks():
    mix = spec.load_traffic("hot_keys")
    t = Traffic(mix, 1000, 5, width=8192)
    keys = np.concatenate([t.entries(r).key for r in range(20)])
    table = t._key_table
    n, s = mix["keys"]["n"], mix["keys"]["s"]
    assert np.unique(table).size == n
    want = 1.0 / np.sum(np.arange(1, n + 1, dtype=np.float64) ** -s)
    assert abs(np.mean(keys == table[0]) / want - 1) < 0.1
