"""``GraphDB(edges=...)`` on the CPU: a db given another's edge tensors
takes every key but a bitmap from it, refuses another CSR or device, and
threads that ask at once for a shared tensor get one tensor, built once,
without a deadlock."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import GraphDB
from repro_torch.graphs import CSRGraph, node_sample, powerlaw_cluster
from repro_torch.obs import SpanLog

torch.set_num_threads(1)

EDGE_KEYS = ("indptr", "indices", "src_ids", "summary:4")


@pytest.fixture(scope="module")
def csr():
    return powerlaw_cluster(n=2000, m_per_node=4, seed=3)


def _sample(csr, seed):
    return {f"v{i}": node_sample(csr.n_nodes, 8, seed=seed * 7 + i)
            for i in (1, 2)}


def test_another_csr_or_device_is_refused(csr):
    edges = GraphDB(csr, {}, device="cpu")
    twin = CSRGraph(indptr=csr.indptr.copy(), indices=csr.indices.copy(),
                    n_nodes=csr.n_nodes)
    with pytest.raises(ValueError, match="another CSR"):
        GraphDB(twin, _sample(csr, 0), device="cpu", edges=edges)
    with pytest.raises(ValueError, match="lives on meta"):
        GraphDB(csr, _sample(csr, 0), device="cpu",
                edges=GraphDB(csr, {}, device="meta"))


@pytest.mark.parametrize("key", EDGE_KEYS)
def test_edge_keys_come_from_the_shared_db(csr, key):
    edges = GraphDB(csr, {}, device="cpu")
    a = GraphDB(csr, _sample(csr, 0), device="cpu", edges=edges)
    b = GraphDB(csr, _sample(csr, 1), device="cpu", edges=edges)
    got = a.dev(key)
    assert got is b.dev(key) is edges.dev(key)
    assert torch.equal(got, GraphDB(csr, {}, device="cpu").dev(key))
    assert key in edges._dev and not a._dev and not b._dev
    assert a.device_bytes() == b.device_bytes() == 0


def test_bitmaps_are_each_dbs_own(csr):
    edges = GraphDB(csr, {}, device="cpu")
    a = GraphDB(csr, _sample(csr, 0), device="cpu", edges=edges)
    b = GraphDB(csr, _sample(csr, 1), device="cpu", edges=edges)
    bm_a, bm_b = a.dev("bitmap:v1"), b.dev("bitmap:v1")
    assert not torch.equal(bm_a, bm_b)
    want = np.zeros(csr.n_nodes, dtype=bool)
    want[a.unary["v1"]] = True
    assert torch.equal(bm_a, torch.from_numpy(want))
    assert list(a._dev) == ["bitmap:v1"] and edges._dev == {}
    assert a.device_bytes() == csr.n_nodes
    with pytest.raises(KeyError):
        edges.dev("bitmap:v1")


@pytest.mark.parametrize("keys", [("indices",) * 8,
                                  ("indices", "src_ids", "bitmap:v1",
                                   "bitmap:v2") * 2])
def test_threads_build_a_shared_tensor_once(csr, keys):
    """Eight threads on two warm graphs ask at once: each key is one
    tensor and one ``graph.build`` record (a bitmap one a graph), and
    every thread joins within its time limit."""
    edges = GraphDB(csr, {}, device="cpu")
    dbs = [GraphDB(csr, _sample(csr, s), device="cpu", edges=edges)
           for s in (0, 1)]
    start = threading.Barrier(len(keys))
    got: dict[int, torch.Tensor] = {}

    def ask(i):
        start.wait(timeout=30)
        got[i] = dbs[i % 2].dev(keys[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    log = SpanLog()
    try:
        with log.recording():
            threads = [threading.Thread(target=ask, args=(i,),
                                        daemon=True)
                       for i in range(len(keys))]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 20
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == len(keys)
    built = sorted((r.attrs["key"], r.attrs["bytes"])
                   for r in log.records if r.name == "graph.build")
    shared = {k for k in keys if not k.startswith("bitmap:")}
    own = {(i % 2, k) for i, k in enumerate(keys) if k.startswith("bitmap:")}
    assert [k for k, _ in built] == sorted(
        list(shared) + [k for _, k in own])
    for i, k in enumerate(keys):
        if k in shared:
            assert got[i] is edges._dev[k]
        else:
            assert got[i] is dbs[i % 2]._dev[k]
