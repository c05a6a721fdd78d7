"""The port's GNNs (``repro.models.gnn``): GatedGCN, PNA, EGNN and MACE
over a COO :class:`GraphBatch`, message passing by ``index_add_`` and
``index_reduce`` with ``jax.ops.segment_*``'s semantics (``data``)."""
from .data import GraphBatch, pad_graph, random_graph_batch
from .gatedgcn import GatedGCNConfig, gatedgcn_forward, init_gatedgcn
from .pna import PNAConfig, init_pna, pna_forward
from .egnn import EGNNConfig, egnn_forward, init_egnn
from .mace import MACEConfig, init_mace, mace_forward

__all__ = [
    "GraphBatch", "pad_graph", "random_graph_batch",
    "GatedGCNConfig", "gatedgcn_forward", "init_gatedgcn",
    "PNAConfig", "init_pna", "pna_forward",
    "EGNNConfig", "egnn_forward", "init_egnn",
    "MACEConfig", "init_mace", "mace_forward",
]
