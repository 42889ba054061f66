"""Train runner: data -> train_step -> checkpoint, wired with the
fault-tolerance layer (watchdog, straggler monitor, restore on start)
(PyTorch port of ``launch/train.py``).  The same loop runs on one device
and, with ``TrainRunner(rules=)`` on every rank of a mesh
(``launch/mesh.run_spmd``), the rules-sharded step: each rank holds its
shards, checkpoints are gathered to rank 0 and restored elastically onto
whatever mesh the rules bring.

Usage (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-32b \\
      --smoke --device cpu --steps 8 --batch 2 --seq 32 --ckpt-dir /tmp/ck

Without ``--device`` it trains on the CUDA card.  ``--layers N`` cuts the
depth.  As in the reference, the command line trains on one device; the
mesh enters through ``TrainRunner(rules=)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.dist import fault_tolerance as FT
from repro_torch.models.registry import get_model
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import data as DATA
from repro_torch.training import train_step as TS


class TrainRunner:
    """Checkpointed, watchdogged train loop (restartable by construction:
    batches are a pure function of step).  ``history`` holds each step's
    loss, grad norm and learning rate, ``step_seconds`` its wall time,
    measured to the loss's host read."""

    def __init__(self, cfg, *, rules=None, ckpt_dir=None, ckpt_every=50,
                 deadline_s=3600.0, dedup=False, device=None):
        self.cfg = cfg
        self.rules = rules
        self.device = (rules.mesh.device if rules is not None
                       else resolve_device(device))
        self.step_fn = TS.make_train_step(cfg, rules=rules)
        self.axes = TS.state_axes(cfg)
        self.specs = TS.state_specs(cfg, rules) if rules is not None \
            else None
        self.ckpt = (CKPT.CheckpointManager(ckpt_dir, rules=rules,
                                            specs=self.specs)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        self.watchdog = FT.StepWatchdog(deadline_s)
        self.straggler = FT.StragglerMonitor()
        self.dedup = DATA.DedupState(device=self.device) if dedup else None
        self.history: list = []
        self.step_seconds: list = []

    def init_or_restore(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = TS.init_state(self.cfg, gen, self.device, rules=self.rules)
        start = 0
        if self.ckpt is not None and \
                CKPT.latest_step(self.ckpt.dir) is not None:
            state, start = self.ckpt.restore_latest(state, rules=self.rules)
            if self.rules is None or self.rules.mesh.rank == 0:
                print(f"[train] restored checkpoint at step {start}")
        return state, start

    def run(self, *, batch: int, seq_len: int, steps: int, seed: int = 0,
            log_every: int = 10):
        state, start = self.init_or_restore(seed)
        it = DATA.make_batch_iterator(self.cfg, batch=batch, seq_len=seq_len,
                                      seed=seed, start_step=start,
                                      dedup=self.dedup, device=self.device)
        losses = []
        for step, b in it:
            if step >= steps:
                break
            b.pop("keep", None)
            b.pop("dup_frac", None)
            self.watchdog.arm(step)
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, b)
            loss = float(metrics["loss"])   # sync point
            dt = time.monotonic() - t0
            self.watchdog.check()
            self.step_seconds.append(dt)
            verdict = self.straggler.observe(step, dt)
            if verdict == "replan":
                print(f"[train] step {step}: persistent straggler — a real "
                      f"deployment would re-shard / swap in a hot spare")
            losses.append(loss)
            self.history.append({"loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"])})
            if step % log_every == 0 and (self.rules is None
                                          or self.rules.mesh.rank == 0):
                print(f"[train] step {step} loss {loss:.4f} "
                      f"gnorm {self.history[-1]['grad_norm']:.3f} "
                      f"lr {self.history[-1]['lr']:.2e} {dt*1e3:.0f}ms")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save_async(step + 1, state, self.axes)
        if self.ckpt is not None:
            self.ckpt.save_async(steps, state, self.axes)
            self.ckpt.wait()
        return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=sorted(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0 = the config's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    try:
        get_model(cfg)
    except ValueError as e:   # a depth off gemma3's superblocks, or a
        # hybrid below one group
        ap.error(str(e))
    runner = TrainRunner(cfg, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, dedup=args.dedup,
                         device=args.device)
    t0 = time.time()
    _, losses = runner.run(batch=args.batch, seq_len=args.seq,
                           steps=args.steps, seed=args.seed)
    if not losses:
        print(f"[train] checkpoint already at step >= {args.steps}; "
              f"nothing to do")
        return 0
    print(f"[train] {args.steps} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not np.isfinite(losses).all():
        raise FloatingPointError("NaN/inf loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
