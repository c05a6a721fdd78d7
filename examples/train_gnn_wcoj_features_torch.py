"""The paper's technique feeding the model zoo, on the PyTorch/CUDA port
(the port of ``examples/train_gnn_wcoj_features.py``): WCOJ structural
features.

Per-node triangle counts — computed by the vectorized LFTJ engine — are
appended to node features before training a GatedGCN.  The join engine
and the GNNs share the same CSR trie.

    PYTHONPATH=src python examples/train_gnn_wcoj_features_torch.py [--device cpu]

Everything runs on the card (``--device cuda``, the default) or, when
asked, on the CPU's plain path.  With ``--ckpt DIR`` each of the two
trainings checkpoints under ``DIR`` and a second run resumes it.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core import VLFTJ, GraphDB, get_query
from repro_torch.graphs import powerlaw_cluster
from repro_torch.models.gnn import GraphBatch
from repro_torch.models.gnn.gatedgcn import (GatedGCNConfig, gatedgcn_loss,
                                             init_gatedgcn)
from repro_torch.train import OptimizerConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args(argv)

    g = powerlaw_cluster(n=800, m_per_node=4, seed=0)
    gdb = GraphDB(g, {}, device=args.device)

    # 1) enumerate triangles with the worst-case-optimal join, scatter
    #    the counts
    tris = VLFTJ(get_query("3-clique"), gdb).enumerate()   # (T, 3), a<b<c
    tri_count = np.zeros(g.n_nodes, np.float32)
    np.add.at(tri_count, tris.ravel(), 1.0)
    print(f"{tris.shape[0]} triangles; max per node "
          f"{int(tri_count.max())}")

    # 2) labels correlated with triangle membership (structure detection)
    rng = np.random.default_rng(0)
    labels = (tri_count > np.median(tri_count)).astype(np.int32)
    base_feat = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)

    def make_batch(with_wcoj: bool) -> GraphBatch:
        feats = [base_feat]
        if with_wcoj:
            feats.append(np.log1p(tri_count)[:, None])
        feat = np.concatenate(feats, 1)
        ea = g.edge_array()
        return GraphBatch(src=ea[:, 0], dst=ea[:, 1], n_nodes=g.n_nodes,
                          node_feat=feat, labels=labels).to(args.device)

    def train(with_wcoj: bool) -> float:
        batch = make_batch(with_wcoj)
        cfg = GatedGCNConfig(n_layers=3, d_hidden=32,
                             d_in=batch.node_feat.shape[1], n_classes=2)
        name = "wcoj" if with_wcoj else "plain"
        tr = Trainer(
            loss_fn=lambda p, b: gatedgcn_loss(p, batch, cfg),
            params=init_gatedgcn(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"),
            opt_cfg=OptimizerConfig(lr=3e-3, warmup_steps=10,
                                    total_steps=args.steps),
            get_batch=lambda s: {"_": np.zeros(1)},
            ckpt_dir=(os.path.join(args.ckpt, name) if args.ckpt
                      else None),
            ckpt_every=args.steps, device=args.device)
        hist = tr.run(args.steps, log_every=args.steps)
        if tr.start_step:
            print(f"{name}: resumed from checkpoint at step "
                  f"{tr.start_step}")
        return hist[-1]["loss"]

    plain = train(with_wcoj=False)
    wcoj = train(with_wcoj=True)
    print(f"final loss without WCOJ features: {plain:.4f}")
    print(f"final loss with    WCOJ features: {wcoj:.4f}")
    if not wcoj < plain:
        raise SystemExit("structural features should help this task")
    print("WCOJ structural features improve the GNN ✓")


if __name__ == "__main__":
    main()
