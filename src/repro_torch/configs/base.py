"""Model/shape config dataclasses shared by all ten architectures.

``ModelConfig`` is a superset of the knobs the assigned families need; each
``configs/<arch>.py`` instantiates the exact published numbers.  ``SHAPES``
defines the four assigned input-shape sets.  The dataclasses are a copy of
the JAX package's; ``activation_dtype`` returns a ``torch.dtype``.  The
dry-run's ``input_specs`` is not part of this package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int               # 0 for attention-free
    num_kv_heads: int
    d_ff: int                    # per-expert width for MoE
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 1e6
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1          # B/C groups (like GQA for SSM)
    conv_width: int = 4
    ssm_chunk: int = 256         # SSD chunk length
    # --- hybrid (zamba2): shared attention block every k SSM blocks ---
    shared_attn_every: int = 0
    # --- hybrid (granitemoehybrid): the mixer of each layer, "mamba" or
    # "attention", each layer with its own FFN (models/hybrid.py); empty
    # for zamba2's shared block ---
    layer_types: Tuple[str, ...] = ()
    shared_d_ff: int = 0         # shared SwiGLU expert beside the routed ones
    # --- GraniteMoe's scalars; each off at its default ---
    attention_multiplier: float = 0.0   # softmax scale; 0 -> 1/sqrt(hd)
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0    # scales each block's output
    logits_scaling: float = 1.0         # logits divided by it
    rms_norm_eps: float = 1e-6
    position_embedding: str = "rope"    # "rope" or "nope" (no positions)
    # --- local/global (gemma3): pattern_local:1 global, window size ---
    local_window: int = 0
    pattern_local: int = 0       # e.g. 5 -> 5 local then 1 global
    # --- enc-dec (seamless) ---
    encoder_layers: int = 0
    # --- vlm (qwen2-vl M-RoPE) ---
    mrope_sections: Tuple[int, ...] = ()
    # --- numerics / padding ---
    dtype: str = "bfloat16"
    pad_heads_to: int = 0        # Megatron-style head padding for TP
    pad_kv_to: int = 0
    # dry-run only: fully unroll the layer scan so per-layer collectives and
    # matmuls appear xL in the partitioned HLO (XLA cost analysis counts a
    # while body once). Training/serving keep the rolled scan (small HLO).
    unroll_layers: bool = False
    # TP implementation: "gspmd" (baseline) or "manual" (shard_map blocks
    # with explicit bf16 psums — §Perf iteration, see dist/tp.py)
    tp_impl: str = "gspmd"
    # decode KV pool dtype: "bfloat16" (baseline) or "int8" (per-token
    # quantized — §Perf iteration, see serving/paged.py)
    kv_cache_dtype: str = "bfloat16"
    # paged-decode per-chip page-capacity factor over the uniform share
    page_capacity_factor: float = 2.0
    # decode attention as ONE fused Pallas dispatch that walks the raw
    # incremental block table in-kernel with double-buffered page DMA
    # (kernels/fused_decode) instead of the two-dispatch slots+compact →
    # attend path.  Gated per path by serving/engine._fused_kernel_reason;
    # a fallback is always logged + surfaced in dryrun meta, never silent.
    fused_kernel: bool = False
    # page-allocator probe strategy: "linear" (the paper's algorithm),
    # "robinhood" (displacement-ordered claims) or "hopscotch"
    # (neighborhood bitmaps, tombstone-free deletes) — see
    # core/probe_strategies.py.  The strategy SEMANTICS always hold; paths
    # a strategy cannot accelerate (the Pallas probe kernel assumes the
    # linear scan) degrade to the jnp oracle, gated by
    # serving/engine._probe_strategy_reason: logged + surfaced in dryrun
    # meta via engine.fallback_report, never silent.
    probe_strategy: str = "linear"

    # on-device telemetry counter plane (obs/counters.py): when True,
    # make_decode_state adds a ``counters`` pytree leaf and the serve step
    # accumulates probe/page/abort/token counts in-graph; they ride the
    # megastep scan and are read out at the existing once-per-K host sync,
    # so instrumentation adds ZERO extra device syncs.  When False the leaf
    # is never created and the compiled program is bitwise-identical to the
    # pre-telemetry one (identity fast path, pinned by tests/test_obs.py).
    telemetry: bool = False

    @property
    def scan_unroll(self) -> int:
        return self.num_layers if self.unroll_layers else 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def n_q(self) -> int:
        return self.pad_heads_to or self.num_heads

    @property
    def n_kv(self) -> int:
        return self.pad_kv_to or self.num_kv_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / local-global attention."""
        return self.family in ("ssm", "hybrid") or self.pattern_local > 0

    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def attn_scale(self) -> Optional[float]:
        """The attention softmax scale when ``attention_multiplier`` sets
        one; None for the default 1/sqrt(hd), which each attention path
        computes as it always has."""
        return self.attention_multiplier or None

    def param_count(self) -> int:
        """Analytic parameter count N (for 6·N·D model FLOPs)."""
        d, V = self.d_model, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.layer_types:
            return emb + _typed_stack_params(self, self.num_experts)
        if self.family == "ssm":
            return emb + self.num_layers * _mamba2_block_params(self)
        if self.family == "hybrid":
            n_shared = self.num_layers // max(self.shared_attn_every, 1)
            shared = _attn_params(self) + _mlp_params(self, self.d_ff) + 2 * d
            return (emb + self.num_layers * _mamba2_block_params(self)
                    + shared)  # shared block counted once (it is shared)
        per_layer = _attn_params(self) + 2 * d
        if self.family == "moe":
            per_layer += (self.num_experts * _mlp_params(self, self.d_ff)
                          + d * self.num_experts)  # router
        else:
            per_layer += _mlp_params(self, self.d_ff)
        n = emb + self.num_layers * per_layer
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            n += self.encoder_layers * (_attn_params(self)
                                        + _mlp_params(self, self.d_ff) + 2 * d)
            n += self.num_layers * (_attn_params(self) + d)
        return n

    def active_param_count(self) -> int:
        """N_active for MoE (experts_per_token of num_experts)."""
        d, V = self.d_model, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.layer_types:
            return emb + _typed_stack_params(self, self.experts_per_token)
        if self.family != "moe":
            return self.param_count()
        per_layer = (_attn_params(self) + 2 * d
                     + self.experts_per_token * _mlp_params(self, self.d_ff)
                     + d * self.num_experts)
        return emb + self.num_layers * per_layer


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.num_heads == 0:
        return 0
    d, hd = cfg.d_model, cfg.hd
    qo = 2 * d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    bias = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd if cfg.qkv_bias else 0
    return qo + kv + bias


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # SwiGLU: gate, up, down


def _typed_stack_params(cfg: ModelConfig, experts: int) -> int:
    """A ``layer_types`` stack without its embedding: each mixer with its
    pre-norm, and in every layer an FFN (``experts`` of the routed
    SwiGLU experts with the router, or one MLP of ``d_ff``), the shared
    expert and the FFN's pre-norm, then the final norm."""
    d = cfg.d_model
    n_attn = cfg.layer_types.count("attention")
    mixers = ((cfg.num_layers - n_attn) * _mamba2_block_params(cfg)
              + n_attn * (_attn_params(cfg) + d))
    if cfg.num_experts:
        ffn = experts * _mlp_params(cfg, cfg.d_ff) + d * cfg.num_experts
    else:
        ffn = _mlp_params(cfg, cfg.d_ff)
    if cfg.shared_d_ff:
        ffn += _mlp_params(cfg, cfg.shared_d_ff)
    return mixers + cfg.num_layers * (ffn + d) + d


def _mamba2_block_params(cfg: ModelConfig) -> int:
    d, di, N, G = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    in_proj = d * (2 * di + 2 * G * N + cfg.ssm_heads)
    conv = cfg.conv_width * (di + 2 * G * N)
    out = di * d
    extra = 2 * cfg.ssm_heads + di  # A, D, norm-ish
    return in_proj + conv + out + extra + d  # + rmsnorm


# ---------------------------------------------------------------------------
# Shapes.

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Is (arch, shape) a runnable cell?  (flag, reason-if-skipped)."""
    if cfg.layer_types:
        return False, ("layer_types stack: runs on one device only (no "
                       "mesh layout for it)")
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode requires "
                       "sub-quadratic attention (DESIGN.md §6)")
    return True, ""

