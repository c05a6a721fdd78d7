"""pna [arXiv:2004.05718]: 4 layers, d_hidden=75,
aggregators mean-max-min-std x scalers id-amp-atten."""
from ..models.gnn.pna import PNAConfig, init_pna, pna_loss
from .common import GNNArch

ARCH = GNNArch(
    arch_id="pna",
    make_cfg=lambda d_in, n_cls: PNAConfig(
        n_layers=4, d_hidden=75, d_in=d_in, n_classes=n_cls),
    init_fn=init_pna,
    loss_fn=pna_loss,
    scan_layers=True,
)
