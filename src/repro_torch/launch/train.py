"""Production training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
        --steps 100 --reduced --ckpt /tmp/ckpt --resume auto

Selects the architecture from the registry, wires the deterministic data
pipeline, and runs the fault-tolerant training loop (a restarted job
resumes from the newest checkpoint).  ``--reduced`` runs the smoke-scale
config.  The port of ``repro.launch.train``, on one device: ``--device``
(``cuda`` by default; it raises without a card, ``cpu`` runs the plain
path) takes the place of the JAX launcher's mesh.  ``--microbatches``
also applies to xDeepFM here, whose full-width step of 65,536 rows holds
about 90 GB of CIN activations in one piece (the JAX launcher passes it
to the LMs alone).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS
from ..data import lm_synthetic_batch, recsys_synthetic_batch
from ..device import resolve_device
from ..models import transformer as tfm
from ..models import xdeepfm as xdf
from ..models.gnn import data as gnn_data
from ..train.loop import Trainer
from ..train.optimizer import OptimizerConfig


def build_trainer(arch_id: str, args) -> Trainer:
    arch = ARCHS[arch_id]
    dev = resolve_device(args.device, "launch.train")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=min(100, args.steps),
                          total_steps=args.steps)
    if arch.family == "lm":
        cfg = arch.reduced_cfg() if args.reduced else arch.cfg
        params = tfm.init_params(cfg, gen, device=dev)
        batch, seq = (8, 64) if args.reduced else (256, 4096)
        return Trainer(
            loss_fn=lambda p, b: tfm.loss_fn(p, b, cfg),
            params=params, opt_cfg=opt,
            get_batch=lambda s: lm_synthetic_batch(
                s, batch, seq, cfg.vocab_size, seed=args.seed),
            ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
            microbatches=args.microbatches, device=dev)
    if arch.family == "gnn":
        g = gnn_data.random_graph_batch(
            256 if args.reduced else 100_000,
            1024 if args.reduced else 1_600_000,
            16, seed=args.seed, coords=True, n_graphs=4).to(dev)
        cfg = arch.make_cfg(16, 16)
        params = arch.init_fn(cfg, gen, device=dev)
        return Trainer(
            loss_fn=lambda p, b: arch.loss_fn(p, g, cfg),
            params=params, opt_cfg=opt,
            get_batch=lambda s: {"step": np.zeros(1)},
            ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, device=dev)
    if arch.family == "recsys":
        cfg = arch.reduced_cfg() if args.reduced else arch.cfg
        params = xdf.init_xdeepfm(cfg, gen, device=dev)
        batch = 256 if args.reduced else 65536
        return Trainer(
            loss_fn=lambda p, b: xdf.xdeepfm_loss(p, b, cfg),
            params=params, opt_cfg=opt,
            get_batch=lambda s: recsys_synthetic_batch(
                s, batch, cfg.n_sparse, cfg.vocab_per_field,
                seed=args.seed),
            ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
            microbatches=args.microbatches, device=dev)
    raise SystemExit(f"--arch {arch_id}: family {arch.family} is not a "
                     "trainable architecture (use launch.serve for wcoj)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device, "launch.train")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the host's CPU")
    print(f"device={dev} ({name})")
    trainer = build_trainer(args.arch, args)
    hist = trainer.run(args.steps, log_every=args.log_every,
                       resume=args.resume)
    for h in hist[-5:]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e} |g| {h['grad_norm']:.2f} "
              f"{h['wall']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
