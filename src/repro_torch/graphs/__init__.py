from .csr import CSRGraph, degrees_from_indptr
from .generators import (SNAP_LIKE, barabasi_albert, erdos_renyi,
                         make_snap_like, powerlaw_cluster, zipf_graph)
from .io import load_edgelist, save_edgelist
from .layout import (HybridLayout, degree_sort_permutation, map_rows_back,
                     renumber_csr)
from .sampling import NeighborSampler, node_sample

__all__ = [
    "CSRGraph", "degrees_from_indptr", "SNAP_LIKE", "barabasi_albert",
    "erdos_renyi", "make_snap_like", "powerlaw_cluster", "zipf_graph",
    "load_edgelist", "save_edgelist",
    "HybridLayout", "degree_sort_permutation", "map_rows_back",
    "renumber_csr", "NeighborSampler", "node_sample",
]
