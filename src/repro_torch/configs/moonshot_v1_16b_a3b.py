"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (kv=16) vocab=163840, MoE 64 experts top-6 (d_ff_expert=1408) + 2
shared experts (Kimi/Moonlight convention).  Expert-parallel sharding:
64 experts / 16 ranks = 4 per rank."""
import torch

from ..layers.moe import MoEConfig
from ..models.transformer import TransformerConfig
from .common import LMArch

CFG = TransformerConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab_size=163840, rope_frac=1.0,
    act="silu", norm="rmsnorm", tie_embeddings=True,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  shard_mode="ep", n_shared_experts=2),
    dtype=torch.bfloat16, remat=True, loss_seq_chunk=512)

ARCH = LMArch(arch_id="moonshot-v1-16b-a3b", cfg=CFG, microbatches=2)
