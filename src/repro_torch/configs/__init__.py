"""Model configurations of the port: the JAX package's values as the
port's :class:`~repro_torch.models.transformer.TransformerConfig` (two
dense LMs and two MoE LMs), :func:`reduced_cfg`, the small-width copy
the CPU tests run, and the four GNN architectures as ``GNNArch``es
(``GATEDGCN``, ``PNA``, ``EGNN``, ``MACE``; ``GNN_SHAPES``).  The
registry of every architecture (``ARCHS``, ``get_arch``) waits for its
slice."""
from .chatglm3_6b import CFG as CHATGLM3_6B
from .common import GNN_SHAPES, GNNArch, reduced_cfg
from .egnn import ARCH as EGNN
from .gatedgcn import ARCH as GATEDGCN
from .granite_moe_3b_a800m import CFG as GRANITE_MOE_3B_A800M
from .mace import ARCH as MACE
from .moonshot_v1_16b_a3b import CFG as MOONSHOT_V1_16B_A3B
from .pna import ARCH as PNA
from .stablelm_3b import CFG as STABLELM_3B

__all__ = ["CHATGLM3_6B", "EGNN", "GATEDGCN", "GNNArch", "GNN_SHAPES",
           "GRANITE_MOE_3B_A800M", "MACE", "MOONSHOT_V1_16B_A3B", "PNA",
           "STABLELM_3B", "reduced_cfg"]
