"""chatglm3-6b [arXiv:2406.12793]: 28L d_model=4096 32H (GQA kv=2)
d_ff=13696 vocab=65024 — 2D RoPE (rotary on half the head dims), GQA."""
import torch

from ..models.transformer import TransformerConfig
from .common import LMArch

CFG = TransformerConfig(
    name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab_size=65024, rope_frac=0.5,
    act="silu", norm="rmsnorm", tie_embeddings=False,
    dtype=torch.bfloat16, remat=True, loss_seq_chunk=512)

ARCH = LMArch(arch_id="chatglm3-6b", cfg=CFG, microbatches=1)
