"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d_model=1536 24H (GQA kv=8)
vocab=49155, MoE 40 experts top-8 (d_ff_expert=512).

40 experts do not divide a 16-way model group, so the expert FFN width
is sharded instead (``shard_mode="tp"``)."""
import torch

from ..layers.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import LMArch

CFG = TransformerConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab_size=49155, rope_frac=1.0,
    act="silu", norm="rmsnorm", tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                  shard_mode="tp"),
    dtype=torch.bfloat16, remat=True, loss_seq_chunk=512)

ARCH = LMArch(arch_id="granite-moe-3b-a800m", cfg=CFG, microbatches=1)
