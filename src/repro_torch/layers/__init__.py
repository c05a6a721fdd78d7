"""Layer primitives of the port's models (norms, rotary embedding,
activations, initializers, float32-accumulating products) and the
Mixture-of-Experts FFN, PyTorch copies of ``repro.layers``."""
from .common import (act_fn, apply_rope, bmm_f32, layernorm, make_norm,
                     matmul, normal_init, normal_init_layers, rmsnorm,
                     rope_frequencies)
from .moe import (MoEConfig, init_moe_params, moe_ffn, moe_param_specs,
                  shard_moe_params)

__all__ = ["act_fn", "apply_rope", "bmm_f32", "layernorm", "make_norm",
           "matmul", "normal_init", "normal_init_layers", "rmsnorm",
           "rope_frequencies", "MoEConfig", "init_moe_params", "moe_ffn",
           "moe_param_specs", "shard_moe_params"]
