"""End-to-end training example (the port's counterpart of
``examples/train_lm.py``): train a small qwen2.5-family model for a few
hundred steps on synthetic data with the full production loop (AdamW and
its cosine schedule, remat, checkpointing, watchdog, the dedup data
pipeline) and check that the loss decreases.

Small by default (~15M params, 300 steps); ``--full`` for the ~100M
variant.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
     [--full] [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import TrainRunner
from repro_torch.models import nn
from repro_torch.models.registry import get_model


def small_lm(full: bool) -> ModelConfig:
    if full:  # ~100M
        return ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
            head_dim=64, qkv_bias=True, tie_embeddings=True, rope_theta=1e4)
    return ModelConfig(  # ~15M
        name="lm-15m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, d_ff=1024, vocab_size=8192,
        head_dim=64, qkv_bias=True, tie_embeddings=True, rope_theta=1e4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)

    cfg = small_lm(args.full)
    with tempfile.TemporaryDirectory() as tmp:
        runner = TrainRunner(cfg, ckpt_dir=args.ckpt_dir or tmp,
                             ckpt_every=100, dedup=True, device=args.device)
        n = sum(p.numel() for p in nn.tree_leaves(
            get_model(cfg).init(cfg, None, "meta")))
        print(f"[example] {cfg.name}: {n/1e6:.1f}M params, "
              f"{args.steps} steps @ batch {args.batch} x seq {args.seq} on "
              f"{runner.device}")
        t0 = time.time()
        _, losses = runner.run(batch=args.batch, seq_len=args.seq,
                               steps=args.steps, log_every=25)
    dt = time.time() - t0
    if not np.isfinite(losses).all():
        raise FloatingPointError("NaN/inf loss")
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    toks = len(losses) * args.batch * args.seq
    print(f"[example] {dt:.0f}s ({toks/dt:.0f} tok/s on {runner.device}); "
          f"loss {first:.3f} -> {last:.3f}")
    if args.steps >= 100 and not last < first - 0.1:
        raise AssertionError("loss did not decrease")
    print("[example] train_lm OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
