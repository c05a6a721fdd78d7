"""The frozen generator repeats for a seed and makes well-formed CSRs
with the configuration's exact edge count; the traffic repeats for a
seed."""
import numpy as np
import pytest

from portbench import graphs, traffic


def well_formed(indptr, indices, n):
    assert indptr.shape == (n + 1,) and indptr[0] == 0
    assert indptr[-1] == indices.shape[0]
    src = np.repeat(np.arange(n), np.diff(indptr))
    assert (src != indices).all()                       # no self loops
    keys = src * n + indices
    assert (np.diff(keys) > 0).all()                    # sorted, no repeats
    assert np.array_equal(np.sort(indices * n + src), keys)   # symmetric


@pytest.mark.parametrize("seed", [0, 5, 2**33 + 7])
def test_chung_lu_repeats_for_a_seed(seed):
    a = graphs.chung_lu(5000, 40000, 2.5, 500, seed % 2**32, "cpu")
    b = graphs.chung_lu(5000, 40000, 2.5, 500, seed % 2**32, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    well_formed(*a, 5000)
    c = graphs.chung_lu(5000, 40000, 2.5, 500, seed % 2**32 + 1, "cpu")
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("n,edges,cap", [(5000, 40000, 500),
                                         (300, 20000, 290),
                                         (12, 66, 20)])
def test_chung_lu_has_exactly_the_edges_asked_for(n, edges, cap):
    """Repeats and loops are drawn again until the count is exact, also
    where they are most of a draw (a dense skewed graph, a complete
    one)."""
    indptr, indices = graphs.chung_lu(n, edges, 2.5, cap, 3, "cpu")
    well_formed(indptr, indices, n)
    assert indices.shape[0] == 2 * edges


def test_chung_lu_refuses_more_edges_than_fit():
    with pytest.raises(ValueError):
        graphs.chung_lu(10, 46, 2.5, 9, 0, "cpu")


def test_chung_lu_degrees_follow_the_weights():
    indptr, _ = graphs.chung_lu(20000, 200000, 2.5, 2000, 1, "cpu")
    deg = np.diff(indptr)
    assert deg.mean() == 20.0
    assert deg.max() <= 2 * 2000
    assert deg[deg > 200].size > 0 and np.median(deg) < 20.0


def test_samples_are_the_servers():
    from repro_torch.graphs import node_sample
    for seed in (0, 9, 2**31 - 1, 2**32 - 1):
        got = graphs.request_samples(1000, 8.0, seed)
        for i in range(1, 5):
            assert np.array_equal(got[f"v{i}"],
                                  node_sample(1000, 8.0, seed=seed * 7 + i))


MIX = {"shapes": ["a", "b", "c"], "selectivity": 8, "clients": 3,
       "engine": "auto"}


def test_pool_streams_repeat_and_send_every_shape_each_round():
    mix = dict(MIX, samples="pool", pool_size=4)
    first, pool = traffic.streams(mix, 2**40 + 3)
    again, pool2 = traffic.streams(mix, 2**40 + 3)
    assert pool == pool2 and len(pool) == 4
    for s, t in zip(first, again):
        reqs = [s.next() for _ in range(30)]
        assert [(r.shape, r.sample_seed) for r in reqs] == \
            [(r.shape, r.sample_seed) for r in (t.next() for _ in range(30))]
        assert {r.sample_seed for r in reqs} <= set(pool)
        for k in range(0, 30, 3):
            assert sorted(r.shape for r in reqs[k:k + 3]) == ["a", "b", "c"]
    other, _ = traffic.streams(mix, 2**40 + 4)
    assert [other[0].next().shape for _ in range(30)] != \
        [r.shape for r in (traffic.streams(mix, 2**40 + 3)[0][0].next()
                           for _ in range(30))]


def test_session_streams_bring_a_fresh_sample_each_round():
    mix = dict(MIX, samples="session")
    first, warm = traffic.streams(mix, 2**40 + 3)
    again, _ = traffic.streams(mix, 2**40 + 3)
    assert len(warm) == 1
    seen = []
    for s, t in zip(first, again):
        reqs = [s.next() for _ in range(30)]
        assert [(r.shape, r.sample_seed) for r in reqs] == \
            [(r.shape, r.sample_seed) for r in (t.next() for _ in range(30))]
        for k in range(0, 30, 3):
            assert sorted(r.shape for r in reqs[k:k + 3]) == ["a", "b", "c"]
            assert len({r.sample_seed for r in reqs[k:k + 3]}) == 1
            seen.append(reqs[k].sample_seed)
    assert len(set(seen)) == len(seen) and not set(seen) & set(warm)


@pytest.mark.parametrize("bad", [{"samples": "cache"},
                                 {"samples": "pool", "pool_size": 0},
                                 {"samples": "pool"}])
def test_a_malformed_mix_is_refused(bad):
    with pytest.raises(ValueError):
        traffic.check_mix(dict(MIX, **bad))
