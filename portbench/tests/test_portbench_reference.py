"""The plain reference against brute-force enumeration, against a
closed form, and against the program's plain CPU path at a size brute
force cannot reach; the control against it."""
import itertools

import numpy as np
import pytest
import torch

from portbench import graphs, reference
from portbench.queries import DATALOG, pattern

SHAPES = sorted(DATALOG)


def brute(indptr, indices, pat, samples) -> int:
    n = indptr.shape[0] - 1
    edges = {(u, int(v)) for u in range(n)
             for v in indices[indptr[u]:indptr[u + 1]]}
    sets = {k: set(v.tolist()) for k, v in samples.items()}
    total = 0
    for values in itertools.product(range(n), repeat=len(pat.variables)):
        m = dict(zip(pat.variables, values))
        total += (all((m[a], m[b]) in edges for a, b in pat.edges)
                  and all(m[v] in sets[r] for r, v in pat.unary))
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_reference_equals_brute_force(shape, seed):
    indptr, indices = graphs.chung_lu(11, 24, 2.5, 8, seed, "cpu")
    samples = graphs.request_samples(11, 2.0, seed)
    g = reference.RefGraph(indptr, indices, "cpu")
    got, peak = reference.count(g, pattern(shape), samples)
    assert got == brute(indptr, indices, pattern(shape), samples)
    assert 0 <= peak < 62


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_equals_the_program_on_the_cpu(shape):
    from repro_torch.core import GraphDB, count, get_query
    from repro_torch.graphs.csr import CSRGraph
    indptr, indices = graphs.chung_lu(1500, 9000, 2.5, 200, 7, "cpu")
    samples = graphs.request_samples(1500, 8.0, 11)
    gdb = GraphDB(CSRGraph(indptr=indptr, indices=indices, n_nodes=1500),
                  samples, device="cpu")
    g = reference.RefGraph(indptr, indices, "cpu")
    assert reference.count(g, pattern(shape), samples)[0] == \
        count(get_query(shape), gdb)


def test_control_rounds_large_counts():
    """The control (float32) gets some count wrong once counts pass
    2^24, on a dense graph a test can hold."""
    indptr, indices = graphs.chung_lu(600, 100000, 2.5, 400, 3, "cpu")
    samples = graphs.request_samples(600, 2.0, 1)
    g = reference.RefGraph(indptr, indices, "cpu")
    wrong = 0
    for shape in SHAPES:
        exact, _ = reference.count(g, pattern(shape), samples)
        low, _ = reference.count(g, pattern(shape), samples, torch.float32)
        wrong += low != exact
    assert wrong > 0


def test_tree_counts_against_a_closed_form():
    """Walks of length 4 in the complete graph K_n: n (n-1)^4."""
    n = 40
    full = np.array([[j for j in range(n) if j != i] for i in range(n)])
    indptr = np.arange(0, n * (n - 1) + 1, n - 1, dtype=np.int64)
    g = reference.RefGraph(indptr, full.reshape(-1), "cpu")
    samples = {"v1": np.arange(n), "v2": np.arange(n)}
    got, peak = reference.count(g, pattern("4-path"), samples)
    assert got == n * (n - 1) ** 4 and peak < 62


def test_the_reference_counts_only_tree_patterns():
    from portbench.queries import Pattern
    cyc = Pattern("3-clique", (("a", "b"), ("a", "c"), ("b", "c")), (),
                  (("a", "b"), ("b", "c")))
    g = reference.RefGraph(np.array([0, 0]), np.array([], np.int64), "cpu")
    with pytest.raises(ValueError):
        reference.count(g, cyc, None)
