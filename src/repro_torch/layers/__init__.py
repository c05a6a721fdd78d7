"""Layer primitives of the port's models (norms, rotary embedding,
activations, initializers), PyTorch copies of ``repro.layers``."""
from .common import (act_fn, apply_rope, layernorm, make_norm, normal_init,
                     rmsnorm, rope_frequencies)

__all__ = ["act_fn", "apply_rope", "layernorm", "make_norm", "normal_init",
           "rmsnorm", "rope_frequencies"]
