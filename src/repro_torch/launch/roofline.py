"""Roofline terms of a dry-run cell (PyTorch port of ``launch/roofline.py``)
against the card the port runs on.

The reference reads its terms off a compiled XLA program (cost analysis,
memory analysis and the partitioned HLO's collectives).  The port compiles
nothing, so every term comes from counts:

* compute — the executed FLOPs of ``launch/flops_model.executed_flops``,
  spread over the chips, at the card's dense bf16 peak;
* memory — ``flops_model.executed_bytes_per_chip`` at the card's HBM rate;
* collective — the bytes one step puts on the wire per chip, recorded from
  ``dist/collectives.COLLECTIVE_STATS`` (or counted from the step's code,
  ``collectives_source``), at the NVLink rate of one card.

There is no HLO to parse.

The card: NVIDIA H100 80GB HBM3 (SXM), at its full 700 W power limit.  A
card set below 700 W runs slower under load; its limit goes beside every
number measured on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: NVIDIA's data sheet
PEAK_FLOPS = 989e12      # dense bf16 FLOP/s per card
HBM_BW = 3.35e12         # HBM bytes/s per card
# NVLink 4 of one H100 SXM: 900 GB/s both directions together, so 450e9
# bytes/s each way (the four-card machine joins its cards all to all)
NVLINK_BW = 450e9
CARD = "NVIDIA H100 80GB HBM3, 700 W"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    executed_flops_total: float    # analytic executed FLOPs (flops_model)
    executed_bytes_per_chip: float # analytic HBM traffic (flops_model)
    collective_wire_bytes: float   # bytes one step sends per chip
    collective_breakdown: Dict[str, Dict[str, float]]
    collectives_source: str        # "recorded" | "analytic"
    model_flops_total: float
    peak_memory_per_chip: float    # params + optimizer / decode state

    @property
    def compute_s(self) -> float:
        return self.executed_flops_total / self.chips / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.executed_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_wire_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return (self.model_flops_total / self.executed_flops_total
                if self.executed_flops_total else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / achievable step time (bound = max of terms)."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        ideal = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return ideal / bound if bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction, card=CARD)
        return d


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D prefill, 2·N_active·B/step
    decode, with the analytic parameter count (MoE: active)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def wire_breakdown(by_op: Dict[str, Dict[str, int]]) -> Dict[str, Dict]:
    """``COLLECTIVE_STATS["by_op"]`` as the roofline's breakdown: calls and
    the bytes sent per op."""
    return {op: {"count": float(v["calls"]), "wire_bytes": float(v["sent"])}
            for op, v in sorted(by_op.items())}
