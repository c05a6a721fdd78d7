"""stablelm-3b [hf:stabilityai/stablelm-2; dims per assignment]:
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
StableLM-2 conventions: LayerNorm, partial rotary (25%), SiLU-gated MLP.
"""
import torch

from ..models.transformer import TransformerConfig
from .common import LMArch

CFG = TransformerConfig(
    name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=6912, vocab_size=50304, rope_frac=0.25,
    act="silu", norm="layernorm", tie_embeddings=True,
    dtype=torch.bfloat16, remat=True, loss_seq_chunk=512)

ARCH = LMArch(arch_id="stablelm-3b", cfg=CFG, microbatches=1)
