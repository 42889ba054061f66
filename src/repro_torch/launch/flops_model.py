"""Analytic EXECUTED-FLOPs model per (arch × shape) (PyTorch port of
``launch/flops_model.py``: the same arithmetic, so both packages' dry-runs
give the same numbers for a cell).

Why analytic: the port's dry-run runs no program (nothing is allocated), so
the roofline compute term comes from this model.  It counts what the
reference's compiled program executes, including:

* remat recompute (nothing_saveable layer policy: dense matmuls 4x fwd,
  flash attention fwd + replay + 5-matmul backward = 9 units / 2 fwd units),
* TP head padding (qwen1.5/2.5 40->48, qwen2-vl 28->32),
* flash kv-chunk rounding of the causal triangle,
* MoE dispatch capacity over-compute (capacity_factor) + router,
* paged-decode page-capacity over-read factor (~2x live tokens),
* the logits matmul (by far the largest single op for big-vocab models).

``ideal`` is the 6·N·D / 2·N·D / 2·N·B convention (MODEL_FLOPS) — the ratio
executed/ideal is the waste diagnostic reported in §Roofline.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig

# The flash-attention kv chunk whose rounding of the causal triangle the
# model counts (the reference's ``models/layers.DEFAULT_KV_CHUNK``).  The
# port's ``models/layers.flash_attention`` chunks only q
# (``DEFAULT_Q_CHUNK``) and scores each q chunk against every key, masked,
# so its own attention executes the whole square: the model keeps the
# reference's count, and the roofline's compute term is its.
DEFAULT_KV_CHUNK = 1024


@dataclasses.dataclass
class FlopsBreakdown:
    attn_proj: float = 0.0
    attn_score: float = 0.0
    mlp: float = 0.0
    ssm: float = 0.0
    logits: float = 0.0
    router: float = 0.0

    @property
    def total(self) -> float:
        return (self.attn_proj + self.attn_score + self.mlp + self.ssm
                + self.logits + self.router)


def _attn_proj_flops(cfg, T) -> float:
    """qkv + o projections, padded head counts (the executed shapes)."""
    d, hd = cfg.d_model, cfg.hd
    return 2.0 * T * d * hd * (2 * cfg.n_q + 2 * cfg.n_kv)


def _attn_score_flops(cfg, B, S, *, window=0, causal=True, Sk=None) -> float:
    """scores + pv matmuls (one forward pass)."""
    hd = cfg.hd
    Sk = Sk if Sk is not None else S
    if window and causal:
        eff = min(window + DEFAULT_KV_CHUNK / 2, Sk)   # chunk rounding
        pairs = B * S * eff
    elif causal:
        # triangle at kv-chunk granularity
        pairs = B * S * (Sk / 2 + DEFAULT_KV_CHUNK / 2)
    else:
        pairs = B * S * Sk
    return 2.0 * 2.0 * cfg.n_q * hd * pairs            # qk + pv


def _mlp_flops(cfg, T, d_ff=None) -> float:
    return 2.0 * 3.0 * T * cfg.d_model * (d_ff or cfg.d_ff)


def _moe_flops(cfg, T) -> float:
    rows = T * cfg.experts_per_token * cfg.moe_capacity_factor
    expert = 2.0 * 3.0 * rows * cfg.d_model * cfg.d_ff
    router = 2.0 * T * cfg.d_model * cfg.num_experts
    return expert + router


def _ssm_flops(cfg, B, S) -> float:
    """Mamba2 block: projections + conv + SSD core (one forward)."""
    T = B * S
    d, di = cfg.d_model, cfg.d_inner
    G, N = cfg.ssm_groups, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    proj = 2.0 * T * d * (2 * di + 2 * G * N + H) + 2.0 * T * di * d
    conv = 2.0 * T * (di + 2 * G * N) * cfg.conv_width
    # SSD: scores CB^T [Q x Q x G x N], intra y [Q x Q x H x P],
    # state in/out [S x H x P x N each]
    nc = max(S // Q, 1)
    ssd = (2.0 * B * nc * Q * Q * G * N          # C B^T
           + 2.0 * B * nc * Q * Q * H * P        # M @ xdt
           + 2.0 * 2.0 * B * S * H * P * N)      # state update + readout
    return proj + conv + ssd


def _logits_flops(cfg, T) -> float:
    return 2.0 * T * cfg.d_model * cfg.vocab_size


# multipliers: fwd / fwd+bwd-with-remat
_DENSE_TRAIN = 4.0        # fwd + remat replay + 2x bwd
_ATTN_TRAIN = 4.5         # (2 fwd + 2 replay + 5 bwd) / 2 fwd units
_NO_REMAT_TRAIN = 3.0     # logits: fwd + 2x bwd (not inside remat scan)

PAGE_CAPACITY_WASTE = 2.0  # decode gathers ~2x the live pages (capacity)


def executed_flops(cfg: ModelConfig, shape: ShapeConfig) -> FlopsBreakdown:
    B, S = shape.global_batch, shape.seq_len
    fb = FlopsBreakdown()

    if shape.kind in ("train", "prefill"):
        T = B * S
        dense_m = _DENSE_TRAIN if shape.kind == "train" else 1.0
        attn_m = _ATTN_TRAIN if shape.kind == "train" else 1.0
        head_m = _NO_REMAT_TRAIN if shape.kind == "train" else 1.0
        T_logits = T if shape.kind == "train" else B  # prefill: last_only

        if cfg.family in ("dense", "moe", "vlm"):
            L = cfg.num_layers
            if cfg.pattern_local:
                ng = L // (cfg.pattern_local + 1)
                n_local = ng * cfg.pattern_local
                n_global = ng
                fb.attn_score += attn_m * (
                    n_local * _attn_score_flops(cfg, B, S,
                                                window=cfg.local_window)
                    + n_global * _attn_score_flops(cfg, B, S))
            else:
                fb.attn_score += attn_m * L * _attn_score_flops(cfg, B, S)
            fb.attn_proj += dense_m * L * _attn_proj_flops(cfg, T)
            if cfg.family == "moe":
                fb.mlp += dense_m * L * _moe_flops(cfg, T)
            else:
                fb.mlp += dense_m * L * _mlp_flops(cfg, T)
        elif cfg.family == "ssm":
            fb.ssm += dense_m * cfg.num_layers * _ssm_flops(cfg, B, S)
        elif cfg.family == "hybrid":
            n_inv = cfg.num_layers // cfg.shared_attn_every
            fb.ssm += dense_m * cfg.num_layers * _ssm_flops(cfg, B, S)
            fb.attn_proj += dense_m * n_inv * _attn_proj_flops(cfg, T)
            fb.attn_score += attn_m * n_inv * _attn_score_flops(cfg, B, S)
            fb.mlp += dense_m * n_inv * _mlp_flops(cfg, T)
        elif cfg.family == "encdec":
            S_src = max(S // 8, 1)
            T_src = B * S_src
            Le, Ld = cfg.encoder_layers, cfg.num_layers
            fb.attn_proj += dense_m * (Le * _attn_proj_flops(cfg, T_src)
                                       + 2 * Ld * _attn_proj_flops(cfg, T))
            fb.attn_score += attn_m * (
                Le * _attn_score_flops(cfg, B, S_src, causal=False)
                + Ld * _attn_score_flops(cfg, B, S)
                + Ld * _attn_score_flops(cfg, B, S, causal=False, Sk=S_src))
            fb.mlp += dense_m * (Le + Ld) * _mlp_flops(cfg, T)
        fb.logits += head_m * _logits_flops(cfg, T_logits)

    else:  # decode: one token per sequence, context length S
        T = B
        live = B * S * PAGE_CAPACITY_WASTE
        if cfg.family in ("dense", "moe", "vlm"):
            L = cfg.num_layers
            if cfg.pattern_local:
                ng = L // (cfg.pattern_local + 1)
                fb.attn_score += 2.0 * 2.0 * cfg.n_q * cfg.hd * (
                    ng * cfg.pattern_local * B * cfg.local_window
                    + ng * live)
            else:
                fb.attn_score += 2.0 * 2.0 * cfg.n_q * cfg.hd * L * live
            fb.attn_proj += L * _attn_proj_flops(cfg, T)
            if cfg.family == "moe":
                fb.mlp += L * _moe_flops(cfg, T)
            else:
                fb.mlp += L * _mlp_flops(cfg, T)
        elif cfg.family == "ssm":
            # O(1) recurrence per token
            d, di = cfg.d_model, cfg.d_inner
            G, N, H, P = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_head_dim)
            per = (2.0 * T * d * (2 * di + 2 * G * N + H) + 2.0 * T * di * d
                   + 2.0 * 2.0 * T * H * P * N)
            fb.ssm += cfg.num_layers * per
        elif cfg.family == "hybrid":
            d, di = cfg.d_model, cfg.d_inner
            G, N, H, P = (cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_head_dim)
            per = (2.0 * T * d * (2 * di + 2 * G * N + H) + 2.0 * T * di * d
                   + 2.0 * 2.0 * T * H * P * N)
            fb.ssm += cfg.num_layers * per
            n_inv = cfg.num_layers // cfg.shared_attn_every
            fb.attn_proj += n_inv * _attn_proj_flops(cfg, T)
            fb.attn_score += 2.0 * 2.0 * cfg.n_q * cfg.hd * n_inv * live
            fb.mlp += n_inv * _mlp_flops(cfg, T)
        elif cfg.family == "encdec":
            S_src = max(S // 8, 1)
            Ld = cfg.num_layers
            fb.attn_proj += 2 * Ld * _attn_proj_flops(cfg, T)
            fb.attn_score += 2.0 * 2.0 * cfg.n_q * cfg.hd * Ld * (
                live + B * S_src)
            fb.mlp += Ld * _mlp_flops(cfg, T)
        fb.logits += _logits_flops(cfg, B)
    return fb


# ---------------------------------------------------------------------------
# Analytic per-chip HBM traffic (the memory roofline term): a coarse model
# (documented coefficients):
#   * weights: read once per pass; per-chip traffic = N·2B / tp (TP slices are
#     local; FSDP gathers materialize the full d-dim before the matmul reads)
#   * activations: ACT_RW r/w events per layer on the residual-stream-sized
#     tensor (q/k/v/scores/mlp-hidden/norms/residuals, averaged)
#   * optimizer: m,v f32 read+write + param read/write, ZeRO-sharded
#   * decode: page-pool reads x capacity waste + recurrent/ring state

ACT_RW = 12.0


def executed_bytes_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                            chips: int, tp: int) -> float:
    n_params = cfg.param_count()
    w_pass = n_params * 2.0 / tp
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model

    if shape.kind in ("train", "prefill"):
        dp = max(chips // tp, 1)
        tokens_chip = B * S / dp
        act = tokens_chip * d * 2.0
        L_eff = cfg.num_layers + (cfg.encoder_layers or 0)
        passes = 3.0 if shape.kind == "train" else 1.0
        total = passes * w_pass + passes * ACT_RW * L_eff * act
        if shape.kind == "train":
            total += 24.0 * n_params / chips          # AdamW m/v/param r+w
            total += 2.0 * n_params * 2.0 / chips     # grad write+read
        return total

    # decode — one token per sequence
    total = w_pass                                     # weights re-read
    n_paged, n_ring = 0, 0
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        if cfg.pattern_local:
            g = cfg.pattern_local + 1
            n_paged = cfg.num_layers // g
            n_ring = cfg.num_layers - n_paged
        else:
            n_paged = cfg.num_layers
    elif cfg.family == "hybrid":
        n_paged = cfg.num_layers // cfg.shared_attn_every
    kv_bytes = (1.0 + 2.0 / cfg.hd if cfg.kv_cache_dtype == "int8"
                else 2.0)                              # + bf16 scale row
    kv_row = cfg.n_kv * cfg.hd * 2 * kv_bytes          # K+V per token
    total += cfg.page_capacity_factor * n_paged * B * S * kv_row / chips
    total += n_ring * B * cfg.local_window * kv_row / chips
    if cfg.family in ("ssm", "hybrid"):
        state = (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
                 * B * cfg.num_layers)
        total += 2.0 * state / chips                   # read + write
    if cfg.family == "encdec":
        S_src = max(S // 8, 1)
        total += cfg.num_layers * B * S_src * kv_row / chips
    return total
