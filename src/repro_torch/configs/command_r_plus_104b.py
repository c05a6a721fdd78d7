"""command-r-plus-104b [hf:CohereForAI]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — no-bias, LayerNorm, tied embeddings.

The JAX package shards it as a 100B-class model (FSDP, a
sequence-parallel residual stream, microbatched gradient accumulation, a
sequence-chunked LM head); the mesh fields do nothing on one card, where
103.8 B parameters (208 GB in bf16) run only with their depth cut."""
import torch

from ..models.transformer import TransformerConfig
from .common import LMArch

CFG = TransformerConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab_size=256000, rope_frac=1.0,
    act="silu", norm="layernorm", use_bias=False, tie_embeddings=True,
    dtype=torch.bfloat16, remat=True, fsdp=True, seq_shard=True,
    loss_seq_chunk=512)

ARCH = LMArch(
    arch_id="command-r-plus-104b",
    cfg=CFG,
    microbatches=8,
    opt_variants={
        # the JAX package's §Perf iterations: B1 drops the explicit q
        # head-shard constraint; B2 also donates params and optimizer
        # state; B3 also halves the microbatch count
        "train_4k_b1": ("train_4k", dict(attn_head_shard=False)),
        "train_4k_b2": ("train_4k", dict(attn_head_shard=False),
                        dict(donate=True)),
        "train_4k_b3": ("train_4k", dict(attn_head_shard=False),
                        dict(donate=True, microbatches=4)),
    },
)
