"""The judge of served tokens, whatever the model: for every served token,
by how much its logit lies below the best logit of the configuration's
float32 reference (``modules.reference(cfg)``: ``hidden`` and ``head``)
at that position.  Greedy decoding in the configuration's precision gives
gaps at rounding level; a wrong token, page or lane gives gaps the size
of the logits' spread.  The fp8 control: every bf16 matmul's weights (per
output channel) and inputs (per row), and the K/V (per token and head),
rounded to float8 e4m3 and back (``Lin``, ``fp8``, which the models'
forwards use).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from perfbench import modules
from perfbench.reference import weights as RW

F8_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to the format's largest value), back in float32."""
    s = (x.abs().amax(dim=dim, keepdim=True) / F8_MAX).clamp_min(1e-12)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Lin:
    """float32 matmuls, or the fp8 control's."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A [in, out] weight in float32 (fp8: one scale per output)."""
        t = t.float()
        return fp8(t, 0) if self.fp8 else t

    def __call__(self, x, w):
        return (fp8(x, -1) if self.fp8 else x) @ w


def served_gaps(cfg: dict, seed: int, device, requests: List[tuple],
                control: bool = False, block: int = 1024) -> dict:
    """Judge served tokens.  ``requests``: (prompt, served tokens) pairs,
    served non-empty.  Returns ``gaps``: per request, the gap of each
    served token (the reference's best logit at that position minus the
    served token's).  With ``control``, also ``control_gaps``: at the same
    positions, the gap of the token the fp8 control puts first.

    Runs TF32 off; the model's ``hidden`` runs layer by layer over all
    sequences at once, so that it fits beside nothing else on the card
    once the program is gone."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _served_gaps(cfg, seed, device, requests, control, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _served_gaps(cfg, seed, device, requests, control, block):
    model = modules.reference(cfg)
    w = RW.draw(cfg, seed, device)
    # the forward runs over prompt + served tokens but the last; row r of
    # a sequence predicts its token r + 1
    seqs, rows, targets, o = [], [], [], 0
    for prompt, served in requests:
        full = np.concatenate([np.asarray(prompt), np.asarray(served)])
        seqs.append(full[:-1])
        nk = len(prompt)
        rows.append(o + np.arange(nk - 1, len(full) - 1))
        targets.append(np.asarray(served))
        o += len(full) - 1
    rows_t = torch.as_tensor(np.concatenate(rows),
                             device=torch.device(device))
    tgt = torch.as_tensor(np.concatenate(targets).astype(np.int64),
                          device=rows_t.device)
    hid = {"f32": model.hidden(cfg, w, seqs, "f32")[rows_t]}
    if control:
        hid["fp8"] = model.hidden(cfg, w, seqs, "fp8")[rows_t]
    lin32, lin8 = Lin(False), Lin(True)
    head32 = lin32.w(model.head(cfg, w))
    head8 = lin8.w(model.head(cfg, w)) if control else None
    mult = 1.0 / cfg.get("logits_scaling", 1.0)
    gap, cgap = [], []
    for b0 in range(0, rows_t.numel(), block):
        sl = slice(b0, b0 + block)
        ref = lin32(hid["f32"][sl], head32) * mult
        best = ref.amax(-1)
        gap.append(best - ref.gather(-1, tgt[sl, None])[:, 0])
        if control:
            top = (lin8(hid["fp8"][sl], head8) * mult).argmax(-1)
            cgap.append(best - ref.gather(-1, top[:, None])[:, 0])
    split = np.cumsum([len(t) for t in targets])[:-1]
    out = {"gaps": np.split(torch.cat(gap).cpu().numpy(), split)}
    if control:
        out["control_gaps"] = np.split(torch.cat(cgap).cpu().numpy(), split)
    return out
