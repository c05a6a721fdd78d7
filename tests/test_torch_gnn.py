"""The GNN models in the port against the JAX package on the same numpy
inputs and the same parameters: the graph containers and generators, the
neighbour sampler, the scatters, GatedGCN, PNA, EGNN and MACE (every
config switch), their configurations and ``Trainer``.

The JAX package's parameters (``init_*(PRNGKey(s), cfg)``) are carried
across with ``convert.gnn_params_from_numpy``.  Tolerances: numpy arrays
bitwise; float32 values 1e-5 (atol and rtol) and gradients 1e-4 of each
leaf's largest |want|; ``compute_bf16`` against the JAX package's bf16
at ``BF16_TOL`` of the largest |want| (see there).  The JAX package runs
with x64 on (``import repro``), so its MACE radial basis is float64
where the port's is float32: differences of ~1e-7, inside 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from scipy.stats import special_ortho_group

import repro  # noqa: F401  (x64, as the JAX package's own tests run)
from repro.configs import ARCHS as J_ARCHS
from repro.graphs import NeighborSampler as JSampler
from repro.graphs import powerlaw_cluster as j_powerlaw
from repro.models.gnn import data as jd
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import gatedgcn as jgcn
from repro.models.gnn import mace as jmace
from repro.models.gnn import pna as jpna
from repro.train import loop as jloop
from repro.train import optimizer as jopt

from repro_torch import configs as tconfigs
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.graphs import NeighborSampler as TSampler
from repro_torch.graphs import powerlaw_cluster as t_powerlaw
from repro_torch.models.gnn import data as td
from repro_torch.models.gnn import egnn as tegnn
from repro_torch.models.gnn import gatedgcn as tgcn
from repro_torch.models.gnn import mace as tmace
from repro_torch.models.gnn import pna as tpna
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
#: ``compute_bf16`` against the JAX package's bf16, relative to the
#: largest |want|: both round the edge basis, the messages, their
#: products, the A-basis, the couplings and the Gaunt tensor to bf16 (8
#: significant bits, 2^-9 each), but the JAX package rounds its float64
#: radial basis (x64) where the port rounds a float32 one, and the two
#: einsums contract the couplings in their own order, so single elements
#: may land one bf16 step (2^-8) apart and move what they feed (measured:
#: 6.4e-8 on the state, 0.0052 on the worst gradient leaf); 2^-5 is the
#: bf16 convention of the training checks on the card
BF16_TOL = 2.0 ** -5

GRAPH_FIELDS = ("src", "dst", "node_feat", "edge_feat", "coords",
                "graph_id", "labels")


def _same_batch(t, j):
    for f in GRAPH_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if b is None:
            assert a is None, f
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert_array_equal(a, b, err_msg=f)
    assert (t.n_nodes, t.n_graphs) == (j.n_nodes, j.n_graphs)


# ---------------------------------------------------------------------------
# graph containers, generators and the sampler (numpy, bitwise)
# ---------------------------------------------------------------------------

BATCH_CASES = [
    dict(n_nodes=40, n_edges=160, d_feat=8, seed=0),
    dict(n_nodes=40, n_edges=161, d_feat=8, seed=1, coords=True),
    dict(n_nodes=64, n_edges=256, d_feat=16, seed=2, coords=True,
         n_graphs=4, n_classes=16),
    dict(n_nodes=30, n_edges=90, d_feat=4, seed=3, d_edge=5, n_graphs=3),
    dict(n_nodes=1, n_edges=4, d_feat=2, seed=7, coords=True, d_edge=1),
]


@pytest.mark.parametrize("kw", BATCH_CASES, ids=range(len(BATCH_CASES)))
def test_random_graph_batch_matches_jax(kw):
    _same_batch(td.random_graph_batch(**kw), jd.random_graph_batch(**kw))


@pytest.mark.parametrize("kw,pad", [(BATCH_CASES[0], (48, 200)),
                                    (BATCH_CASES[2], (64, 300)),
                                    (BATCH_CASES[3], (31, 90)),
                                    (BATCH_CASES[1], (41, 161))],
                         ids=range(4))
def test_pad_graph_matches_jax(kw, pad):
    t = td.pad_graph(td.random_graph_batch(**kw), *pad)
    j = jd.pad_graph(jd.random_graph_batch(**kw), *pad)
    _same_batch(t, j)


@pytest.mark.parametrize("n,m,seed,pad_to,fill",
                         [(50, 3, 2, 8, -1), (50, 3, 2, None, -1),
                          (120, 4, 0, 64, 7), (30, 2, 5, 1, -1),
                          (30, 2, 5, 0, -1)])
def test_padded_neighbors_matches_jax(n, m, seed, pad_to, fill):
    tn, tm = t_powerlaw(n, m, seed=seed).padded_neighbors(pad_to, fill)
    jn, jm = j_powerlaw(n, m, seed=seed).padded_neighbors(pad_to, fill)
    assert tn.dtype == jn.dtype and tm.dtype == jm.dtype
    assert_array_equal(tn, jn)
    assert_array_equal(tm, jm)


@pytest.mark.parametrize("fanouts,seed,batch",
                         [((5, 3), 1, 16), ((15, 10), 0, 64),
                          ((4,), 3, 300), ((2, 2, 2), 9, 5)])
def test_neighbor_sampler_matches_jax(fanouts, seed, batch):
    """The same seed gives the same hops, two calls in a row included
    (the generator advances alike); the mirror of
    ``tests/test_checkpoint_and_data.py``'s sampler test."""
    tg, jg = t_powerlaw(300, 3, seed=0), j_powerlaw(300, 3, seed=0)
    ts, js = TSampler(tg, fanouts, seed=seed), JSampler(jg, fanouts,
                                                        seed=seed)
    nodes = np.arange(batch)
    for _ in range(2):
        th, jh = ts.sample(nodes), js.sample(nodes)
        assert len(th) == len(jh) == len(fanouts)
        for a, b in zip(th, jh):
            for k in ("src", "nbr", "mask"):
                assert a[k].dtype == b[k].dtype
                assert_array_equal(a[k], b[k])
    for i in range(min(batch, 16)):
        nbrs = set(tg.neighbors(i).tolist())
        if nbrs:
            assert set(th[0]["nbr"][i].tolist()) <= nbrs


def test_sampler_on_an_edgeless_graph_matches_jax():
    from repro.graphs import CSRGraph as JCSR
    from repro_torch.graphs import CSRGraph as TCSR
    ptr = np.zeros(5, np.int64)
    idx = np.zeros(0, np.int64)
    th = TSampler(TCSR(ptr, idx, 4), (3, 2), seed=0).sample(np.arange(4))
    jh = JSampler(JCSR(ptr, idx, 4), (3, 2), seed=0).sample(np.arange(4))
    for a, b in zip(th, jh):
        for k in ("src", "nbr", "mask"):
            assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the scatters and the gather
# ---------------------------------------------------------------------------

SCATTERS = ("sum", "max", "min", "mean")

SCATTER_CASES = {
    # (E, trailing shape, ids, n)
    "random": (40, (3,), np.random.default_rng(0).integers(0, 7, 40), 7),
    "empty_segment": (6, (2,), np.array([0, 1, 1, 0, 2, 2]), 4),
    "ids_outside": (6, (2,), np.array([0, 5, -1, 1, 2, 7]), 3),
    "all_outside": (3, (), np.array([-3, 4, 9]), 3),
    "irreps": (12, (4, 9), np.random.default_rng(1).integers(0, 5, 12), 5),
}


def _scatter(lib, op):
    return getattr(lib, f"scatter_{op}")


@pytest.mark.parametrize("case", list(SCATTER_CASES))
@pytest.mark.parametrize("op", SCATTERS)
def test_scatter_matches_jax(op, case):
    """Values (``-inf``/``+inf`` on empty segments, ids outside ``[0, n)``
    dropped) and the gradient of ``sum(out * ct)`` over the finite
    outputs, against ``jax.ops.segment_*``."""
    e, rest, ids, n = SCATTER_CASES[case]
    rng = np.random.default_rng(len(case) + len(op))
    msg = rng.standard_normal((e,) + rest).astype(np.float32)
    ct = rng.standard_normal((n,) + rest).astype(np.float32)

    def jloss(m):
        out = _scatter(jd, op)(m, jnp.asarray(ids), n)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * ct), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(msg))
    tm = torch.tensor(msg, requires_grad=True)
    tout = _scatter(td, op)(tm, torch.as_tensor(ids), n)
    torch.where(torch.isfinite(tout), tout, 0.0).mul(
        torch.as_tensor(ct)).sum().backward()
    assert tout.shape == jout.shape
    assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    assert_allclose(tm.grad.numpy(), np.asarray(jgrad), **TOL)


def test_empty_segments_are_infinite_and_dropped_ids_vanish():
    """The measured facts the scatters are built on: JAX's max of an
    empty segment is -inf (min +inf), and an id outside [0, n) adds
    nothing."""
    msg = torch.tensor([1.0, 2.0, 2.0])
    ids = torch.tensor([0, 1, 1])
    assert td.scatter_max(msg, ids, 3).tolist() == [1.0, 2.0, float("-inf")]
    assert td.scatter_min(msg, ids, 3).tolist() == [1.0, 2.0, float("inf")]
    assert td.scatter_sum(torch.ones(3), torch.tensor([0, 5, -1]),
                          2).tolist() == [1.0, 0.0]


def test_tied_maxima_on_the_pad_graph_dummy_split_the_gradient():
    """``pad_graph``'s padding edges are self-loops on the dummy node, so
    their messages tie; both packages split the max's gradient evenly
    among them (``[0.5, 0.5, 0, 1]`` in the small case)."""
    t = td.scatter_max(torch.tensor([1.0, 1.0, 0.5, 3.0],
                                    requires_grad=True),
                       torch.tensor([0, 0, 0, 1]), 2)
    t.sum().backward()
    jg = jax.grad(lambda m: jd.scatter_max(m, jnp.array([0, 0, 0, 1]),
                                           2).sum())(
        jnp.array([1.0, 1.0, 0.5, 3.0]))
    assert_array_equal(np.asarray(jg), [0.5, 0.5, 0.0, 1.0])

    g = td.pad_graph(td.random_graph_batch(20, 40, 4, seed=0), 24, 64)
    k = 64 - 40                                      # padding edges
    rng = np.random.default_rng(0)
    h = rng.standard_normal((24, 4)).astype(np.float32)
    ct = rng.standard_normal((24, 4)).astype(np.float32)
    msg = h[g.src]                                   # ties on the dummy

    def jl(m):
        out = jd.scatter_max(m, jnp.asarray(g.dst), 24)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * ct)

    jgrad = np.asarray(jax.grad(jl)(jnp.asarray(msg)))
    tm = torch.tensor(msg, requires_grad=True)
    out = td.scatter_max(tm, torch.as_tensor(g.dst), 24)
    torch.where(torch.isfinite(out), out, 0.0).mul(
        torch.as_tensor(ct)).sum().backward()
    tgrad = tm.grad.numpy()
    assert_allclose(tgrad, jgrad, **TOL)
    # the dummy's own messages: every padding edge holds ct / k
    pad = np.arange(40, 64)
    assert_allclose(tgrad[pad], np.broadcast_to(ct[23] / k, (k, 4)),
                    rtol=1e-6)


def test_gather_reads_ids_as_jax_indexing_does():
    x = np.arange(5, dtype=np.float32)[:, None] * 10
    ids = np.array([-1, -7, 5, 100, -5, -6, 2])
    want = np.asarray(jnp.asarray(x)[jnp.asarray(ids)])
    got = td.gather(torch.as_tensor(x), torch.as_tensor(ids)).numpy()
    assert_array_equal(got, want)


def test_scatter_refuses_ids_on_another_device():
    """A batch tensor on another device than the messages raises (here a
    meta tensor stands in for the card's) instead of being moved."""
    with pytest.raises(ValueError, match="GraphBatch.to"):
        td.scatter_sum(torch.ones(3), torch.zeros(3, dtype=torch.int64,
                                                  device="meta"), 2)


# ---------------------------------------------------------------------------
# the models against the JAX package on converted parameters
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_vg(loss, p, g, cfg):
    return jax.value_and_grad(lambda pp: loss(pp, g, cfg))(p)


def _port_vg(loss, p, g, cfg):
    return tloop.value_and_grad(lambda pp, _: loss(pp, g, cfg), p, None)


def _grads_close(tgrads, jgrads, tol=GRAD_TOL):
    jl = jax.tree.leaves(jgrads)
    assert len(tgrads) == len(jl)
    for got, want in zip(tgrads, jl):
        want = np.asarray(want, dtype=np.float64)
        got = got.detach().double().numpy()
        assert got.shape == want.shape
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= tol * scale, (
            np.abs(got - want).max(), scale)


def _graph(n=40, e=160, d=8, seed=0, **kw):
    return (td.random_graph_batch(n, e, d, seed=seed, **kw),
            jd.random_graph_batch(n, e, d, seed=seed, **kw))


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("d_edge", [0, 3])
def test_gatedgcn_matches_jax(n_layers, d_edge):
    """2 layers (JAX unrolls) and 3 (JAX scans), with and without edge
    features."""
    tg, jg = _graph(d_edge=d_edge, n_classes=5)
    kw = dict(n_layers=n_layers, d_hidden=12, d_in=8, d_edge_in=d_edge,
              n_classes=5)
    jcfg, tcfg = jgcn.GatedGCNConfig(**kw), tgcn.GatedGCNConfig(**kw)
    jp = jgcn.init_gatedgcn(jax.random.PRNGKey(n_layers), jcfg)
    tp = gnn_params_from_numpy(_np_tree(jp), device="cpu")
    assert_allclose(tgcn.gatedgcn_forward(tp, tg, tcfg).detach().numpy(),
                    np.asarray(jgcn.gatedgcn_forward(jp, jg, jcfg)), **TOL)
    jl, jgr = _jax_vg(jgcn.gatedgcn_loss, jp, jg, jcfg)
    tl, tgr = _port_vg(tgcn.gatedgcn_loss, tp, tg, tcfg)
    assert_allclose(float(tl), float(jl), **TOL)
    _grads_close(tgr, jgr)


@pytest.mark.parametrize("n_layers", [2, 3])
@pytest.mark.parametrize("padded", [False, True])
def test_pna_matches_jax(n_layers, padded):
    """2 and 3 layers; the padded graph adds an isolated node (``has_nbr``
    masks its ±inf), ties on the dummy and zero variances."""
    tg, jg = _graph(n_classes=6)
    if padded:   # pad_graph keeps the labels: pad them to the nodes
        labels = np.pad(tg.labels, (0, 4))
        tg = dataclasses.replace(td.pad_graph(tg, 44, 200), labels=labels)
        jg = dataclasses.replace(jd.pad_graph(jg, 44, 200), labels=labels)
    kw = dict(n_layers=n_layers, d_hidden=10, d_in=8, n_classes=6)
    jcfg, tcfg = jpna.PNAConfig(**kw), tpna.PNAConfig(**kw)
    jp = jpna.init_pna(jax.random.PRNGKey(3), jcfg)
    tp = gnn_params_from_numpy(_np_tree(jp), device="cpu")
    assert_allclose(tpna.pna_forward(tp, tg, tcfg).detach().numpy(),
                    np.asarray(jpna.pna_forward(jp, jg, jcfg)), **TOL)
    jl, jgr = _jax_vg(jpna.pna_loss, jp, jg, jcfg)
    tl, tgr = _port_vg(tpna.pna_loss, tp, tg, tcfg)
    assert_allclose(float(tl), float(jl), **TOL)
    _grads_close(tgr, jgr)


@pytest.mark.parametrize("n_layers,n_graphs", [(2, 1), (3, 4)])
def test_egnn_matches_jax(n_layers, n_graphs):
    tg, jg = _graph(coords=True, n_graphs=n_graphs)
    kw = dict(n_layers=n_layers, d_hidden=16, d_in=8)
    jcfg, tcfg = jegnn.EGNNConfig(**kw), tegnn.EGNNConfig(**kw)
    jp = jegnn.init_egnn(jax.random.PRNGKey(5), jcfg)
    tp = gnn_params_from_numpy(_np_tree(jp), device="cpu")
    assert isinstance(tp["layers"], list)
    th, tx = tegnn.egnn_forward(tp, tg, tcfg)
    jh, jx = jegnn.egnn_forward(jp, jg, jcfg)
    assert_allclose(th.detach().numpy(), np.asarray(jh), **TOL)
    assert_allclose(tx.detach().numpy(), np.asarray(jx), **TOL)
    assert_allclose(tegnn.egnn_energy(tp, tg, tcfg).detach().numpy(),
                    np.asarray(jegnn.egnn_energy(jp, jg, jcfg)), **TOL)
    jl, jgr = _jax_vg(jegnn.egnn_loss, jp, jg, jcfg)
    tl, tgr = _port_vg(tegnn.egnn_loss, tp, tg, tcfg)
    assert_allclose(float(tl), float(jl), **TOL)
    _grads_close(tgr, jgr)


MACE_VARIANTS = {
    "outer": {},
    "loop": dict(a_basis_mode="loop"),
    "couple_chunks_3": dict(couple_chunks=3),        # N = 31: 31 % 3 = 1
    "remat": dict(remat=True),
    "shard_couple": dict(shard_couple=True, a_basis_mode="loop"),
    "all": dict(a_basis_mode="loop", couple_chunks=4, remat=True,
                shard_couple=True),
}


def _mace_case(over, seed=0, n_layers=2):
    tg, jg = _graph(31, 124, 8, seed=seed, coords=True, n_graphs=1)
    kw = dict(n_layers=n_layers, d_hidden=16, d_in=8, **over)
    jcfg, tcfg = jmace.MACEConfig(**kw), tmace.MACEConfig(**kw)
    jp = jmace.init_mace(jax.random.PRNGKey(seed + 11), jcfg)
    tp = gnn_params_from_numpy(_np_tree(jp), device="cpu")
    return tg, jg, tcfg, jcfg, tp, jp


@pytest.mark.parametrize("variant", list(MACE_VARIANTS))
def test_mace_matches_jax(variant):
    tg, jg, tcfg, jcfg, tp, jp = _mace_case(MACE_VARIANTS[variant])
    assert_allclose(tmace.mace_forward(tp, tg, tcfg).detach().numpy(),
                    np.asarray(jmace.mace_forward(jp, jg, jcfg)), **TOL)
    assert_allclose(tmace.mace_energy(tp, tg, tcfg).detach().numpy(),
                    np.asarray(jmace.mace_energy(jp, jg, jcfg)), **TOL)
    jl, jgr = _jax_vg(jmace.mace_loss, jp, jg, jcfg)
    tl, tgr = _port_vg(tmace.mace_loss, tp, tg, tcfg)
    assert_allclose(float(tl), float(jl), **TOL)
    _grads_close(tgr, jgr)


@pytest.mark.parametrize("mode", ["outer", "loop"])
def test_mace_bf16_matches_jax_bf16(mode):
    """``compute_bf16`` in both packages, at ``BF16_TOL`` of the largest
    |want| (state, energy, loss and every gradient leaf); both also stay
    within ``BF16_TOL`` of their own float32 forward."""
    over = dict(compute_bf16=True, a_basis_mode=mode, couple_chunks=2)
    tg, jg, tcfg, jcfg, tp, jp = _mace_case(over)
    ts = tmace.mace_forward(tp, tg, tcfg).detach().double().numpy()
    js = np.asarray(jmace.mace_forward(jp, jg, jcfg), np.float64)
    assert ts.dtype == js.dtype
    scale = np.abs(js).max()
    assert np.abs(ts - js).max() <= BF16_TOL * scale
    f32 = tmace.mace_forward(tp, tg, dataclasses.replace(
        tcfg, compute_bf16=False)).detach().double().numpy()
    assert np.abs(ts - f32).max() <= BF16_TOL * np.abs(f32).max()
    jl, jgr = _jax_vg(jmace.mace_loss, jp, jg, jcfg)
    tl, tgr = _port_vg(tmace.mace_loss, tp, tg, tcfg)
    assert abs(float(tl) - float(jl)) <= BF16_TOL * abs(float(jl))
    _grads_close(tgr, jgr, tol=BF16_TOL)


def test_mace_state_is_float32_under_bf16():
    """``m`` starts as bf16 zeros like ``a`` and turns float32 with its
    first float32 term, so the state stays float32."""
    tg, _, tcfg, _, tp, _ = _mace_case(dict(compute_bf16=True))
    assert tmace.mace_forward(tp, tg, tcfg).dtype == torch.float32


def test_mace_remat_recomputes_each_layer(monkeypatch):
    """With ``remat`` each layer runs under ``torch.utils.checkpoint``
    while gradients are on, and not under ``torch.no_grad``."""
    calls = []
    real = tmace.checkpoint
    monkeypatch.setattr(tmace, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tg, _, tcfg, _, tp, _ = _mace_case(dict(remat=True), n_layers=3)
    _port_vg(tmace.mace_loss, tp, tg, tcfg)
    assert len(calls) == 3
    with torch.no_grad():
        tmace.mace_forward(tp, tg, tcfg)
    assert len(calls) == 3


def test_gaunt_and_sph_harm_match_jax():
    assert_allclose(tmace.gaunt_tensor(), jmace.gaunt_tensor(), atol=1e-12,
                    rtol=0)
    assert_array_equal(tmace.L_OF, jmace.L_OF)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((200, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = np.asarray(jmace.real_sph_harm(jnp.asarray(v)))
    got = tmace.real_sph_harm(torch.as_tensor(v)).numpy()
    assert got.dtype == np.float64
    assert_allclose(got, want, atol=1e-12, rtol=0)
    assert_allclose(tmace._real_sph_harm_np(v), jmace._real_sph_harm_np(v),
                    atol=1e-12, rtol=0)
    g = tmace.gaunt_tensor()
    assert_allclose(g[0], np.eye(9) * 0.5 / np.sqrt(np.pi), atol=1e-12)


@pytest.mark.parametrize("seed", [0, 17, 941])
def test_egnn_equivariance(seed):
    """The mirror of the JAX package's property test, at its tolerance."""
    g = td.random_graph_batch(40, 160, 8, seed=seed % 100, coords=True)
    cfg = tegnn.EGNNConfig(d_in=8, n_layers=2, d_hidden=16)
    p = tegnn.init_egnn(cfg, torch.Generator().manual_seed(seed % 97),
                        device="cpu")
    rot = special_ortho_group.rvs(3, random_state=seed % 1000)
    shift = np.asarray([1.0, -2.0, 0.5])
    g2 = dataclasses.replace(
        g, coords=(np.asarray(g.coords) @ rot.T + shift).astype(np.float32))
    with torch.no_grad():
        h1, x1 = tegnn.egnn_forward(p, g, cfg)
        h2, x2 = tegnn.egnn_forward(p, g2, cfg)
    assert_allclose(h1.numpy(), h2.numpy(), atol=1e-3, rtol=1e-3)
    assert_allclose(x1.numpy() @ rot.T + shift, x2.numpy(), atol=1e-3,
                    rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 17, 941])
def test_mace_rotation_invariance(seed):
    g = td.random_graph_batch(30, 120, 8, seed=seed % 100, coords=True,
                              n_graphs=3)
    cfg = tmace.MACEConfig(d_in=8, d_hidden=16)
    p = tmace.init_mace(cfg, torch.Generator().manual_seed(seed % 89),
                        device="cpu")
    rot = special_ortho_group.rvs(3, random_state=seed % 1000)
    g2 = dataclasses.replace(
        g, coords=(np.asarray(g.coords) @ rot.T).astype(np.float32))
    with torch.no_grad():
        e1 = tmace.mace_energy(p, g, cfg)
        e2 = tmace.mace_energy(p, g2, cfg)
    assert_allclose(e1.numpy(), e2.numpy(), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# configurations, the batch on a device, Trainer
# ---------------------------------------------------------------------------

GNN_ARCHS = {"gatedgcn": tconfigs.GATEDGCN, "pna": tconfigs.PNA,
             "egnn": tconfigs.EGNN, "mace": tconfigs.MACE}


@pytest.mark.parametrize("arch_id", list(GNN_ARCHS))
def test_arch_smoke(arch_id):
    """The mirror of ``tests/test_arch_configs.py``'s smoke test."""
    out = GNN_ARCHS[arch_id].smoke(device="cpu")
    assert all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("arch_id", list(GNN_ARCHS))
def test_arch_matches_jax(arch_id):
    """Shapes (opt variants merged), flags and full-width configs equal
    the JAX package's; the port's loss of the JAX package's parameters at
    full width equals its loss."""
    t, j = GNN_ARCHS[arch_id], J_ARCHS[arch_id]
    assert t.shapes == j.shapes and t.opt_variants == j.opt_variants
    assert (t.needs_coords, t.scan_layers, t.family) == (
        j.needs_coords, j.scan_layers, j.family)
    assert dataclasses.asdict(t.make_cfg(16, 16)) == dataclasses.asdict(
        j.make_cfg(16, 16))
    assert tconfigs.GNN_SHAPES == {k: v for k, v in j.shapes.items()
                                   if "base" not in v}
    cfg = t.make_cfg(16, 16)
    jp = j.init_fn(jax.random.PRNGKey(0), j.make_cfg(16, 16))
    tg, jg = _graph(64, 256, 16, coords=True, n_graphs=4, n_classes=16)
    tl = t.loss_fn(gnn_params_from_numpy(_np_tree(jp), device="cpu"), tg,
                   cfg)
    assert_allclose(float(tl), float(j.loss_fn(jp, jg, j.make_cfg(16, 16))),
                    **TOL)


def test_graph_batch_to_moves_every_array_once():
    g = td.random_graph_batch(20, 40, 4, seed=0, coords=True, d_edge=2,
                              n_graphs=2)
    m = g.to("cpu")
    assert m.src.dtype == m.dst.dtype == m.graph_id.dtype == torch.int64
    assert m.node_feat.dtype == m.coords.dtype == torch.float32
    assert m.labels.dtype == torch.int32
    assert (m.n_nodes, m.n_graphs, m.n_edges) == (20, 2, 40)
    assert_array_equal(m.src.numpy(), g.src)
    assert td.random_graph_batch(5, 4, 2).to("cpu").coords is None
    cfg = tgcn.GatedGCNConfig(n_layers=2, d_hidden=8, d_in=4, d_edge_in=2)
    p = tgcn.init_gatedgcn(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert_array_equal(tgcn.gatedgcn_forward(p, m, cfg).detach().numpy(),
                       tgcn.gatedgcn_forward(p, g, cfg).detach().numpy())


@pytest.mark.parametrize("arch_id", ["gatedgcn", "mace"])
def test_trainer_matches_jax(arch_id):
    """Three ``Trainer`` steps of a GNN loss closed over one graph (the
    JAX launcher's way) on the same parameters: losses within 1e-5."""
    t, j = GNN_ARCHS[arch_id], J_ARCHS[arch_id]
    over = dict(n_layers=2, d_hidden=12) if arch_id == "gatedgcn" else \
        dict(d_hidden=12)
    jcfg = dataclasses.replace(j.make_cfg(16, 16), **over)
    tcfg = dataclasses.replace(t.make_cfg(16, 16), **over)
    tg, jg = _graph(48, 192, 16, coords=True, n_graphs=4, n_classes=16)
    jp = j.init_fn(jax.random.PRNGKey(1), jcfg)
    tp = gnn_params_from_numpy(_np_tree(jp), device="cpu")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=3)
    batch = lambda s: {"step": np.zeros(1)}
    jt = jloop.Trainer(lambda p, b: j.loss_fn(p, jg, jcfg), jp,
                       jopt.OptimizerConfig(**kw), batch)
    tt = tloop.Trainer(lambda p, b: t.loss_fn(p, tg, tcfg), tp,
                       topt.OptimizerConfig(**kw), batch, device="cpu")
    jh, th = jt.run(3, log_every=1), tt.run(3, log_every=1)
    assert len(jh) == len(th) == 3
    for a, b in zip(th, jh):
        assert_allclose(a["loss"], b["loss"], **TOL)
        assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
