"""Model configurations of the port: the JAX package's values as the
port's :class:`~repro_torch.models.transformer.TransformerConfig` (two
dense LMs and two MoE LMs), and :func:`reduced_cfg`, the small-width
copy the CPU tests run.  The registry of the other architectures waits
for its slice."""
from .chatglm3_6b import CFG as CHATGLM3_6B
from .common import reduced_cfg
from .granite_moe_3b_a800m import CFG as GRANITE_MOE_3B_A800M
from .moonshot_v1_16b_a3b import CFG as MOONSHOT_V1_16B_A3B
from .stablelm_3b import CFG as STABLELM_3B

__all__ = ["CHATGLM3_6B", "GRANITE_MOE_3B_A800M", "MOONSHOT_V1_16B_A3B",
           "STABLELM_3B", "reduced_cfg"]
