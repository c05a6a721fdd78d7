"""Train a small LM end to end on the PyTorch/CUDA port (the port of
``examples/train_lm.py``).

The full loop: deterministic pipeline, AdamW + cosine, gradient
accumulation, asynchronous fault-tolerant checkpoints, auto-resume (run
it twice with the same ``--ckpt`` and the second run continues from the
first one's last checkpoint).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 [--device cpu]

The model trains on the card (``--device cuda``, the default) or, when
asked, on the CPU's plain path.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            loss_fn)
from repro_torch.train import OptimizerConfig, Trainer


def get_batch(step: int) -> dict:
    """A learnable synthetic stream: tokens follow t+1 = (3t+7) % V with
    noise, so a falling loss proves the pipeline end to end."""
    rng = np.random.default_rng(step)
    b, s = 16, 64
    t0 = rng.integers(0, 1024, (b, 1))
    seq = [t0]
    for _ in range(s):
        nxt = (3 * seq[-1] + 7) % 1024
        flip = rng.random((b, 1)) < 0.05
        nxt = np.where(flip, rng.integers(0, 1024, (b, 1)), nxt)
        seq.append(nxt)
    arr = np.concatenate(seq, 1).astype(np.int32)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro-torch-lm-ckpt"))
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = TransformerConfig(
        name="demo-lm", n_layers=args.layers, d_model=args.d_model,
        n_heads=4, n_kv_heads=2, d_ff=4 * args.d_model, vocab_size=1024,
        dtype=torch.float32, remat=False)
    print(f"model: {cfg.n_params/1e6:.2f}M params on {args.device}")

    trainer = Trainer(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        params=init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu"),
        opt_cfg=OptimizerConfig(lr=3e-3, warmup_steps=20,
                                total_steps=args.steps),
        get_batch=get_batch, ckpt_dir=args.ckpt,
        ckpt_every=min(50, args.steps), microbatches=2,
        device=args.device)
    resumed = trainer.maybe_resume()
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")
    hist = trainer.run(args.steps, log_every=min(20, args.steps),
                       resume="none")
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.3f}  "
              f"lr {h['lr']:.2e}  |g| {h['grad_norm']:.2f}")
    if hist[-1]["loss"] >= hist[0]["loss"]:
        raise SystemExit("the loss must decrease")
    print("final loss", round(hist[-1]["loss"], 3),
          "(checkpoints in", args.ckpt + ")")


if __name__ == "__main__":
    main()
