"""What the LM configurations share: the small-width copy of a config."""
from __future__ import annotations

from dataclasses import replace

import torch

from ..models.transformer import TransformerConfig


def reduced_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The JAX package's ``LMArch.reduced_cfg``: two layers, d_model 64,
    4 heads of 16 dims, at most 4 KV heads, d_ff 128, vocab 512, float32,
    a 64-token cache; an MoE config keeps 8 experts, ``min(2, top_k)``
    picks, expert width 64 and at most one shared expert."""
    moe = cfg.moe
    if moe is not None:
        moe = replace(moe, n_experts=8, top_k=min(2, moe.top_k),
                      d_ff_expert=64,
                      n_shared_experts=min(1, moe.n_shared_experts))
    return replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads)), d_head=16, d_ff=128,
        vocab_size=512, moe=moe, dtype=torch.float32, fsdp=False,
        seq_shard=False, loss_seq_chunk=0, max_cache_len=64)
