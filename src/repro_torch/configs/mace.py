"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max=2,
correlation order 3, 8 RBF, E(3)-equivariant ACE product basis."""
from ..models.gnn.mace import MACEConfig, init_mace, mace_loss
from .common import GNNArch

ARCH = GNNArch(
    arch_id="mace",
    make_cfg=lambda d_in, n_cls: MACEConfig(
        n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8,
        d_in=d_in),
    init_fn=init_mace,
    loss_fn=mace_loss,
    needs_coords=True,
    opt_variants={
        # the JAX package's §Perf iterations on its worst baseline cell
        "ogb_products_c1": ("ogb_products",
                            dict(a_basis_mode="loop")),
        "ogb_products_c2": ("ogb_products",
                            dict(a_basis_mode="loop", compute_bf16=True)),
        "ogb_products_c3": ("ogb_products",
                            dict(a_basis_mode="loop", compute_bf16=True,
                                 couple_chunks=16)),
        "ogb_products_c4": ("ogb_products",
                            dict(a_basis_mode="loop", shard_couple=True),
                            dict(pad_nodes=True)),
        "ogb_products_c6": ("ogb_products",
                            dict(a_basis_mode="loop", shard_couple=True,
                                 remat=True),
                            dict(pad_nodes=True)),
        "ogb_products_c5": ("ogb_products",
                            dict(a_basis_mode="loop", shard_couple=True,
                                 remat=True),
                            dict(pad_nodes=True)),
    },
)
