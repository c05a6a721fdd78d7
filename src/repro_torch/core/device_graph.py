"""Device-resident graph database for the port's engines.

The edge relation lives as CSR (``indptr``/``indices``) int32 tensors;
unary sample predicates live as dense boolean bitmaps over the node
domain.  Every device tensor lives on ``gdb.device``, which defaults to
``"cuda"``: a ``GraphDB`` asked for the card where there is none raises
rather than landing on the CPU.  Pass ``device="cpu"`` to run the plain
PyTorch path.

:class:`HybridGraphDB` adds the degree-adaptive layout
(``graphs/layout.py``): vertices renumbered by descending degree, hub
neighborhoods also packed as bitset rows, and per-vertex representation
tags, so the level step can route membership checks to the bit test.

``bitset_words`` is stored as **int32 bit patterns** — a
``.view(np.int32)`` of the uint32 words — because ``torch.uint32`` has
only partial operator support.  ``((w >> s) & 1) != 0`` stays exact on
int32 (the arithmetic shift only changes bits above the one tested), and
the CUDA kernel reads the same words as ``uint32_t``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph
from ..graphs.layout import (HybridLayout, degree_sort_permutation,
                             map_rows_back, renumber_csr)
from .relation import Database, Relation


@dataclass
class GraphDB:
    """Host+device view of an ``edge`` CSR plus unary node sets."""

    csr: CSRGraph
    unary: dict[str, np.ndarray] = field(default_factory=dict)
    device: torch.device | str = "cuda"

    # device tensors, built lazily
    _dev: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def n_nodes(self) -> int:
        return self.csr.n_nodes

    @property
    def max_degree(self) -> int:
        return self.csr.max_degree

    @property
    def bsearch_iters(self) -> int:
        return int(math.ceil(math.log2(max(2, self.max_degree)))) + 1

    def _put(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _build(self, key: str) -> torch.Tensor:
        if key == "indptr":
            return self._put(self.csr.indptr, torch.int32)
        if key == "indices":
            return self._put(self.csr.indices, torch.int32)
        if key == "src_ids":  # edge -> source node id (for segment sums)
            return self._put(np.repeat(
                np.arange(self.csr.n_nodes, dtype=np.int32),
                self.csr.degrees), torch.int32)
        if key.startswith("bitmap:"):
            name = key.split(":", 1)[1]
            bm = np.zeros(self.csr.n_nodes, dtype=bool)
            ids = self.unary[name]
            bm[ids[ids < self.csr.n_nodes]] = True
            return self._put(bm, torch.bool)
        if key.startswith("summary:"):  # every s-th index (bsearch2)
            stride = int(key.split(":", 1)[1])
            return self._put(
                np.ascontiguousarray(self.csr.indices[::stride]), torch.int32)
        raise KeyError(key)

    def dev(self, key: str) -> torch.Tensor:
        """The device tensor for ``key`` (``indptr``, ``indices``,
        ``src_ids``, ``summary:<s>``, ``bitmap:<u>``), built on first
        use."""
        v = self._dev.get(key)
        if v is None:
            v = self._dev[key] = self._build(key)
        return v

    def device_bytes(self) -> int:
        """Bytes of the device tensors built so far."""
        return sum(t.numel() * t.element_size() for t in self._dev.values())

    def to_database(self) -> Database:
        """Bridge to the host reference engines.  Reads the host CSR and
        unary sets only, so a db on the card copies nothing back."""
        rels = {"edge": self.csr.to_relation()}
        for name, ids in self.unary.items():
            rels[name] = Relation.from_set(ids, name)
        return Database(rels)

    @classmethod
    def from_database(cls, db: Database,
                      device: torch.device | str = "cuda") -> "GraphDB":
        edge = db.relations["edge"]
        csr = CSRGraph.from_edges(edge.data[:, 0], edge.data[:, 1],
                                  symmetrize=True)
        unary = {name: r.data[:, 0]
                 for name, r in db.relations.items()
                 if r.arity == 1}
        return cls(csr, unary, device=device)


@dataclass
class HybridGraphDB(GraphDB):
    """A :class:`GraphDB` carrying the degree-adaptive hybrid layout.

    The CSR is (by default) renumbered so hubs occupy the id prefix
    ``[0, layout.n_hubs)``; ``layout`` also stores those hubs'
    neighborhoods as bitset rows.  Counts are renumbering-invariant for
    filter-free queries and for ``LessThan`` chains that quotient a query
    automorphism (cliques); order filters that only slice the id space
    (the 4-cycle's ``a<b<c<d``) are evaluated in the renumbered space, so
    compare engines on the same db.

    Extra device keys: ``"bitset_words"`` — the (n_hubs, n_words) int32
    bit patterns of the uint32 bitset matrix; ``"rep_tag"`` — per-vertex
    int32 representation tag (bitset row for hubs, -1 otherwise).
    """

    layout: HybridLayout | None = None
    order: np.ndarray | None = None        # new id -> old id
    new_of_old: np.ndarray | None = None   # old id -> new id

    @classmethod
    def build(cls, csr: CSRGraph, unary: dict[str, np.ndarray] | None = None,
              renumber: bool = True, device: torch.device | str = "cuda",
              **layout_kw) -> "HybridGraphDB":
        """Renumber by descending degree, remap unary sets, pack hub
        bitsets.  ``layout_kw`` forwards to :meth:`HybridLayout.build`."""
        device = resolve_device(device)
        unary = dict(unary or {})
        if renumber:
            order, inv = degree_sort_permutation(csr)
            csr = renumber_csr(csr, inv)
            unary = {name: np.sort(inv[np.asarray(ids, dtype=np.int64)])
                     for name, ids in unary.items()}
        else:
            order = np.arange(csr.n_nodes, dtype=np.int64)
            inv = order
        layout = HybridLayout.build(csr, **layout_kw)
        return cls(csr=csr, unary=unary, device=device, layout=layout,
                   order=order, new_of_old=inv)

    @classmethod
    def from_gdb(cls, gdb: GraphDB, renumber: bool = True,
                 **layout_kw) -> "HybridGraphDB":
        """The hybrid layout of ``gdb``'s graph, on ``gdb.device``."""
        return cls.build(gdb.csr, gdb.unary, renumber=renumber,
                         device=gdb.device, **layout_kw)

    @property
    def n_hubs(self) -> int:
        return self.layout.n_hubs if self.layout is not None else 0

    def rows_to_original(self, rows: np.ndarray) -> np.ndarray:
        """Map result rows (renumbered ids) back to the original ids."""
        return map_rows_back(rows, self.order)

    def _build(self, key: str) -> torch.Tensor:
        if key in ("bitset_words", "rep_tag") and self.layout is None:
            raise KeyError(key)
        lay = self.layout
        if key == "bitset_words":
            # keep at least one row so the tensor is gatherable
            w = lay.words if lay.n_hubs else np.zeros((1, lay.n_words),
                                                      dtype=np.uint32)
            return self._put(np.ascontiguousarray(w, dtype=np.uint32)
                             .view(np.int32), torch.int32)
        if key == "rep_tag":
            return self._put(lay.rep_tags(), torch.int32)
        return super()._build(key)
