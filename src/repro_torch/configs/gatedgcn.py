"""gatedgcn [arXiv:2003.00982]: 16 layers, d_hidden=70, gated aggregator."""

from ..models.gnn.gatedgcn import (GatedGCNConfig, gatedgcn_loss,
                                   init_gatedgcn)
from .common import GNNArch

ARCH = GNNArch(
    arch_id="gatedgcn",
    make_cfg=lambda d_in, n_cls: GatedGCNConfig(
        n_layers=16, d_hidden=70, d_in=d_in, n_classes=n_cls),
    init_fn=init_gatedgcn,
    loss_fn=gatedgcn_loss,
    scan_layers=True,
)
