"""Deterministic, restart-safe synthetic data pipeline with hash-table-based
n-gram dedup (PyTorch port of ``training/data.py``).

Batches are a pure function of (seed, step): restoring a checkpoint needs
only the step counter — no iterator state, no host-side files.  Token
streams are Zipf-distributed (realistic softmax/embedding access skew).
The reference draws with ``jax.random`` (threefry), whose bits change with
jax's version; here each batch comes from an explicit CPU
``torch.Generator`` seeded from ``(seed, step)``, with the reference's
``exp(log V · u)`` transform, so the bits are the same on every device and
the batch is moved to the run's device afterwards.

Dedup (the paper's table in the data path): every sequence contributes
8-gram fingerprints; the port's batched table (``core/batched``) keeps the
seen-set — duplicate-heavy sequences are flagged in the batch's ``keep``
mask.  Tombstone reuse lets the dedup window *slide* (old fingerprints
deleted, cells reclaimed) without ever rebuilding the table.  The
fingerprints and the table after every ``filter_batch`` equal the
reference's bit for bit on the same tokens.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import batched as BT
from repro_torch.core import encoding as E
from repro_torch.core.hashing import MASK32
from repro_torch.device import resolve_device

_MASK63 = (1 << 63) - 1


def _stream_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, step)
    (splitmix64's finalizer over the pair)."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def synth_batch(cfg, *, batch: int, seq_len: int, step: int,
                seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Batch of next-token LM data: tokens [B,S] and labels (shift-by-one),
    int64; encdec adds ``src_embeds``, vlm ``patch_embeds`` and
    ``mrope_positions``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(_stream_seed(seed, step))
    # Zipf-ish marginal over the vocab via exponential transform
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((batch, seq_len + 1),
                                         generator=gen)
    log_v = torch.log(torch.tensor(float(cfg.vocab_size)))
    ranks = torch.floor(torch.exp(log_v * u)) - 1
    toks = torch.clamp(ranks.to(torch.int64), 0, cfg.vocab_size - 1)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dtype = cfg.activation_dtype()
    if cfg.family == "encdec":
        out["src_embeds"] = torch.randn(
            (batch, max(seq_len // 8, 1), cfg.d_model),
            generator=gen).to(dtype)
    if cfg.family == "vlm":
        n_patch = min(256, seq_len // 2)
        out["patch_embeds"] = torch.randn(
            (batch, n_patch, cfg.d_model), generator=gen).to(dtype)
        pos = torch.arange(seq_len)[None, None]
        out["mrope_positions"] = pos.expand(3, batch, seq_len).contiguous()
    return {k: v.contiguous().to(dev) for k, v in out.items()}


# ---------------------------------------------------------------------------
# n-gram dedup on the paper's hash table.

NGRAM = 8
FPR_PER_SEQ = 16  # fingerprints sampled per sequence


def _offsets(S: int, n: int, k: int) -> np.ndarray:
    """``jnp.linspace(0, max(S - n - 1, 0), k).astype(int32)`` bit for bit:
    float32 ``stop * (i / (k - 1))``, the endpoint exact, truncated."""
    stop = max(S - n - 1, 0)
    if k == 1:
        return np.zeros(1, np.int32)
    step = np.arange(k - 1, dtype=np.float32) / np.float32(k - 1)
    out = np.float32(stop) * step
    return np.append(out, np.float32(stop)).astype(np.int32)


def _fingerprints(tokens: torch.Tensor, n: int = NGRAM,
                  k: int = FPR_PER_SEQ) -> torch.Tensor:
    """tokens [B,S] -> int64[B,k] rolling-hash n-gram fingerprints at k
    evenly spaced offsets: ``h * 0x01000193 ^ g`` wrapping at 32 bits, then
    ``% MAX_KEY`` (the reference's uint32 arithmetic, in int64 with
    masks)."""
    offs = torch.from_numpy(_offsets(tokens.shape[1], n, k).astype(np.int64))
    idx = (offs[:, None] + torch.arange(n)[None, :]).to(tokens.device)
    grams = tokens[:, idx].to(torch.int64) & MASK32           # [B,k,n]
    h = torch.zeros(grams.shape[:2], dtype=torch.int64, device=tokens.device)
    for i in range(n):
        h = ((h * 0x01000193) & MASK32) ^ grams[:, :, i]
    return h % E.MAX_KEY


class DedupState:
    """Sliding-window dedup: fingerprints inserted now are deleted
    ``window`` batches later (tombstone reuse keeps occupancy bounded)."""

    def __init__(self, m: int = 1 << 16, window: int = 64, device=None):
        self.table = BT.create(m, seed=7, device=device)
        self.window = window
        self.ring: list = []

    def filter_batch(self, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (keep_mask bool[B], dup_frac scalar).  A sequence is a
        duplicate if most of its fingerprints are already in the table."""
        fps = _fingerprints(tokens.to(self.table.table.device))
        B, k = fps.shape
        flat = fps.reshape(-1)
        seen = BT.lookup_batch(self.table, flat).reshape(B, k)
        dup_frac = seen.float().mean(dim=1)
        keep = dup_frac < 0.5
        self.table, _ = BT.insert_batch(self.table, flat)
        self.ring.append(flat)
        if len(self.ring) > self.window:
            old = self.ring.pop(0)
            self.table, _ = BT.delete_batch(self.table, old)
        return keep, dup_frac.mean()


def make_batch_iterator(cfg, *, batch: int, seq_len: int, seed: int = 0,
                        start_step: int = 0,
                        dedup: Optional[DedupState] = None, device=None):
    """Stateless-per-step iterator (restart-safe); optional dedup flags
    (``keep``, ``dup_frac``) beside each batch."""
    step = start_step
    while True:
        b = synth_batch(cfg, batch=batch, seq_len=seq_len, step=step,
                        seed=seed, device=device)
        if dedup is not None:
            keep, frac = dedup.filter_batch(b["tokens"])
            b["keep"] = keep
            b["dup_frac"] = frac
        yield step, b
        step += 1
