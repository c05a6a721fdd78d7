"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, MLP 400-400.  Embedding tables: 1M rows/field
(Criteo-scale), one float32 table of 39 M rows on one card."""
from ..models.xdeepfm import XDeepFMConfig
from .common import RecsysArch

ARCH = RecsysArch(
    arch_id="xdeepfm",
    cfg=XDeepFMConfig(
        n_sparse=39, embed_dim=10, vocab_per_field=1_000_000,
        cin_layers=(200, 200, 200), mlp_dims=(400, 400)),
)
