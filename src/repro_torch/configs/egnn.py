"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant."""
from ..models.gnn.egnn import EGNNConfig, egnn_loss, init_egnn
from .common import GNNArch

ARCH = GNNArch(
    arch_id="egnn",
    make_cfg=lambda d_in, n_cls: EGNNConfig(
        n_layers=4, d_hidden=64, d_in=d_in),
    init_fn=init_egnn,
    loss_fn=egnn_loss,
    needs_coords=True,
)
