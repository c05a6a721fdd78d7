"""Model configurations of the port: the JAX package's values as the
port's :class:`~repro_torch.models.transformer.TransformerConfig`, and
:func:`reduced_cfg`, the small-width copy the CPU tests run.  The registry
of the other architectures waits for its slice."""
from .chatglm3_6b import CFG as CHATGLM3_6B
from .common import reduced_cfg
from .stablelm_3b import CFG as STABLELM_3B

__all__ = ["CHATGLM3_6B", "STABLELM_3B", "reduced_cfg"]
