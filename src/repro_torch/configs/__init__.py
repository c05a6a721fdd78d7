"""Model configurations of the port and the architecture registry:
``--arch <id>`` resolves here (``ARCHS``, :func:`get_arch`), the JAX
package's 11 architectures under its ids and in its order: five LMs
(``LMArch``: stablelm-3b, chatglm3-6b, command-r-plus-104b,
moonshot-v1-16b-a3b, granite-moe-3b-a800m), four GNNs (``GNNArch``),
xDeepFM (``RecsysArch``) and the paper's join engine (``WCOJArch``).
The LM configs are also exported as bare ``TransformerConfig``s
(``STABLELM_3B`` ...), the GNN records as ``GATEDGCN`` ..., with
:func:`reduced_cfg`, the small-width copy of an LM config that the CPU
tests run."""
from .chatglm3_6b import ARCH as _chatglm3
from .chatglm3_6b import CFG as CHATGLM3_6B
from .command_r_plus_104b import ARCH as _commandr
from .command_r_plus_104b import CFG as COMMAND_R_PLUS_104B
from .common import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, GNNArch, LMArch,
                     RecsysArch, reduced_cfg)
from .egnn import ARCH as EGNN
from .gatedgcn import ARCH as GATEDGCN
from .granite_moe_3b_a800m import ARCH as _granite
from .granite_moe_3b_a800m import CFG as GRANITE_MOE_3B_A800M
from .mace import ARCH as MACE
from .moonshot_v1_16b_a3b import ARCH as _moonshot
from .moonshot_v1_16b_a3b import CFG as MOONSHOT_V1_16B_A3B
from .pna import ARCH as PNA
from .stablelm_3b import ARCH as _stablelm
from .stablelm_3b import CFG as STABLELM_3B
from .wcoj import WCOJ_SHAPES, WCOJArch
from .xdeepfm import ARCH as XDEEPFM

ARCHS = {
    a.arch_id: a for a in [
        _stablelm, _chatglm3, _commandr, _moonshot, _granite,
        GATEDGCN, EGNN, PNA, MACE, XDEEPFM, WCOJArch(),
    ]
}


def get_arch(arch_id: str):
    return ARCHS[arch_id]


__all__ = ["ARCHS", "CHATGLM3_6B", "COMMAND_R_PLUS_104B", "EGNN",
           "GATEDGCN", "GNNArch", "GNN_SHAPES", "GRANITE_MOE_3B_A800M",
           "LMArch", "LM_SHAPES", "MACE", "MOONSHOT_V1_16B_A3B", "PNA",
           "RECSYS_SHAPES", "RecsysArch", "STABLELM_3B", "WCOJArch",
           "WCOJ_SHAPES", "XDEEPFM", "get_arch", "reduced_cfg"]
