"""Tensor-parallel block application and the decode gates (PyTorch port
of ``dist/tp.py``).

Two implementations behind one call signature, selected by
``cfg.tp_impl``:

- ``"gspmd"``: the plain ``models.layers`` block on full (replicated)
  parameters;
- ``"manual"``: Megatron blocks on this rank's shards — column-parallel
  QKV and gate/up, row-parallel output projections, one psum over
  ``model`` after attention and one after the MLP.  The batch is split
  over the (pod, data) axes when divisible and replicated otherwise.

The reference's ``shard_map`` cuts the global operands at the region's
edge; here each rank is handed its pieces up front: ``block_param_specs``
gives the specs the caller cuts a block's parameters with
(``dist/sharding.local_shard``), ``_dp_axes`` the batch split.  The
train-side manual path falls back to the plain block whenever it cannot
apply (no rules, no ``model`` axis wider than 1, head counts or d_ff not
divisible), and then wants full parameters.

Decode side (``serving/engine``'s fused manual serve step): the gate
(``decode_manual_unsupported`` gives a reason for every refusal, which the
engine logs), the specs of the stacked decode params
(``decode_param_specs``), the KV replication factor (``decode_kv_rep``),
the mamba head-sharding gate (``decode_ssm_tp``) and the per-rank manual
projections (``mlp_decode_manual``, ``logits_decode_manual``).  A 1-wide
model axis still takes the fused path.
"""
from __future__ import annotations

from repro_torch.dist import collectives as C
from repro_torch.dist import ctx
from repro_torch.dist.sharding import P
from repro_torch.models import layers as L
from repro_torch.models import nn


def _manual_tp(cfg, rules, *, need_ff: bool) -> int:
    """TP width when the manual path applies, else 0."""
    if cfg.tp_impl != "manual" or rules is None:
        return 0
    tp = rules.mesh.shape.get("model", 0)
    if tp <= 1 or "model" in ctx.current_manual_axes():
        return 0
    if cfg.n_q % tp or cfg.n_kv % tp:
        return 0
    if need_ff and cfg.d_ff % tp:
        return 0
    return tp


def _dp_axes(mesh, batch: int):
    """Mesh axes the batch dim is split over (empty -> replicated
    redundant compute on the non-model axes, still correct)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes if axes and batch % n == 0 else ()


def _attn_specs(ap):
    specs = {"wq": P(None, "model", None), "wk": P(None, "model", None),
             "wv": P(None, "model", None), "wo": P("model", None, None)}
    if "bq" in ap:
        specs.update(bq=P("model", None), bk=P("model", None),
                     bv=P("model", None))
    return specs


_MLP_SPECS = {"wi_gate": P(None, "model"), "wi_up": P(None, "model"),
              "wo": P("model", None)}


def block_param_specs(cfg, rules, p):
    """Specs a rank cuts one block's parameters ``p`` (attn, ln1 and, when
    ``p`` has them, mlp and ln2) with: Megatron shards when the manual path
    applies, replicated otherwise."""
    if not _manual_tp(cfg, rules, need_ff="mlp" in p):
        return P()
    specs = {k: P() for k in p}
    specs["attn"] = _attn_specs(p["attn"])
    if "mlp" in p:
        specs["mlp"] = dict(_MLP_SPECS)
    return specs


def batch_spec(rules, batch: int) -> P:
    """The spec of a [B, ...] activation in the manual forward."""
    dp = _dp_axes(rules.mesh, batch) if rules is not None else ()
    return P(dp) if dp else P()


def _attn_manual(cfg, ap, ln, x, positions, window, mrope):
    """x [B_l,S,d] -> attention sublayer output (pre-residual) on this
    rank's head shard, row-parallel wo + psum over ``model``."""
    q, k, v = L.attn_qkv(ap, nn.norm(cfg, ln, x))
    q, k = L.position_qk(cfg, q, k, positions, mrope)
    o = L.flash_attention(q, k, v, causal=True, window=window,
                          scale=cfg.attn_scale)
    return C.psum(L.attn_out(ap, o), "model")


def _mlp_manual(cfg, mp, ln, x):
    """SwiGLU MLP on a d_ff column shard, row-parallel wo + psum."""
    return C.psum(L.mlp_apply(mp, nn.norm(cfg, ln, x)), "model")


def block_apply_sharded(cfg, p, x, positions, *, causal: bool = True):
    """A pre-norm (attn + MLP) block on this rank's pieces of ``p`` as a
    rules table cut them (``serve_rules``: heads, KV heads and d_ff over
    ``model`` where they divide): the Megatron forward of
    ``block_apply_tp`` — column-parallel QKV and gate/up, row-parallel
    outputs with one psum over ``model`` each — on whatever the rules
    sharded, the plain sublayer on what they left whole.  ``x`` is
    replicated.  The encdec encoder runs through it on a mesh."""
    ap = p["attn"]
    h = L.self_attention(ap, nn.norm(cfg, p["ln1"], x), positions, cfg,
                         causal=causal)
    hq, hkv = ap["wq"].shape[1], ap["wk"].shape[1]
    if hq < cfg.n_q:
        if hkv * (cfg.n_q // cfg.n_kv) != hq:
            raise ValueError(f"q heads sharded to {hq} of {cfg.n_q} but KV "
                             f"heads to {hkv} of {cfg.n_kv}: the local "
                             f"groups do not line up")
        h = C.psum(h, "model")
    x = x + nn.residual(cfg, h)
    y = L.mlp_apply(p["mlp"], nn.norm(cfg, p["ln2"], x))
    if p["mlp"]["wo"].shape[0] < cfg.d_ff:
        y = C.psum(y, "model")
    return x + nn.residual(cfg, y)


# ---------------------------------------------------------------------------
# Decode-side manual TP (serving/engine's fused serve step).

def decode_kv_rep(cfg, tp: int) -> int:
    """KV-head replication factor at TP width ``tp``: 1 when n_kv % tp ==
    0 (plain head sharding), ``tp // n_kv`` when the mesh is WIDER than
    the KV head count (each KV head replicated across the surplus width,
    one head per rank), 0 when neither divides (unsupported shape)."""
    if tp <= 0:
        return 0
    if cfg.n_kv % tp == 0:
        return 1
    if cfg.n_kv and tp % cfg.n_kv == 0:
        return tp // cfg.n_kv
    return 0


def decode_manual_unsupported(cfg, rules):
    """Why the fused manual decode region cannot apply — None when it can.
    Shape-only: ``tp_impl="manual"``, active rules with a ``model`` axis
    not already manual, ``n_q`` divisible by the TP width, a valid KV
    replication factor and a divisible FFN (or expert) count.  tp == 1 is
    allowed.  The strings are the reference's."""
    if cfg.tp_impl != "manual":
        return f"tp_impl={cfg.tp_impl!r} (not 'manual')"
    if rules is None:
        return "no active sharding rules"
    tp = rules.mesh.shape.get("model", 0)
    if tp < 1:
        return "mesh has no 'model' axis"
    if "model" in ctx.current_manual_axes():
        return "already inside a manual region owning 'model'"
    if cfg.n_q % tp:
        return f"n_q={cfg.n_q} not divisible by tp={tp}"
    if not decode_kv_rep(cfg, tp):
        return (f"n_kv={cfg.n_kv} neither divides nor is divided by "
                f"tp={tp} (no whole-head shard or replication)")
    if cfg.family == "moe":
        if cfg.num_experts % tp:
            return (f"num_experts={cfg.num_experts} not divisible by "
                    f"tp={tp}")
    elif cfg.d_ff % tp:
        return f"d_ff={cfg.d_ff} not divisible by tp={tp}"
    return None


def decode_manual_tp(cfg, rules) -> int:
    """TP width for the fused manual decode region, 0 when inapplicable."""
    if decode_manual_unsupported(cfg, rules) is not None:
        return 0
    return rules.mesh.shape["model"]


def decode_ssm_tp(cfg, tp: int) -> bool:
    """Whether the mamba decode math shards its per-head dims over
    ``model``: shared B/C streams (``ssm_groups == 1``) and a head count
    and inner width divisible by the TP width; otherwise the backbone runs
    replicated (redundant, still correct).  ``tp == 1`` passes."""
    if tp < 1 or cfg.ssm_state <= 0 or cfg.ssm_heads <= 0:
        return False
    if cfg.ssm_groups != 1:
        return False
    Hg = cfg.ssm_heads // cfg.ssm_groups
    return Hg % tp == 0 and cfg.d_inner % tp == 0


def _mamba_param_specs():
    """Specs of the STACKED mamba layer params when head-sharded: per-head
    outputs column-parallel over ``model``, the shared B/C streams
    replicated, ``w_out`` row-parallel."""
    return {
        "w_z": P(None, None, "model"),       # [L, d, di]
        "w_x": P(None, None, "model"),
        "w_bc": P(),
        "w_dt": P(None, None, "model"),      # [L, d, H]
        "conv_x_w": P(None, None, "model"),  # [L, W, di]
        "conv_x_b": P(None, "model"),
        "conv_bc_w": P(), "conv_bc_b": P(),
        "A_log": P(None, "model"), "dt_bias": P(None, "model"),
        "D": P(None, "model"),
        "norm": P(None, "model"),
        "w_out": P(None, "model", None),     # [L, di, d]
    }


def decode_megastep_mode(cfg, rules, K: int) -> str:
    """The decode megastep's dispatch tag as the reference records it
    (``"scan-K{K}"`` for K > 1, ``"per-token"`` otherwise).  The port runs
    the K tokens as one Python loop per call on every family and mesh."""
    del cfg, rules
    return f"scan-K{K}" if K > 1 else "per-token"


def decode_param_specs(cfg, params, *, vocab_sharded: bool,
                       kv_rep: int = 1, ssm_tp: bool = False):
    """Specs (a prefix tree) of the fused manual decode params: stacked
    layer weights column/row-parallel over ``model``, everything else
    replicated; ``vocab_sharded`` shards the untied lm_head over the vocab
    dim.  With ``kv_rep > 1`` the K/V projections stay replicated (each
    rank computes every KV head and keeps its own).  ``hybrid``: the one
    shared block is Megatron-sharded and the mamba backbone head-sharded
    when ``ssm_tp``."""
    kvw = P() if kv_rep > 1 else P(None, None, "model", None)
    kvb = P() if kv_rep > 1 else P(None, "model", None)
    if cfg.family == "hybrid":
        sh_attn = {"wq": P(None, "model", None),
                   "wk": P() if kv_rep > 1 else P(None, "model", None),
                   "wv": P() if kv_rep > 1 else P(None, "model", None),
                   "wo": P("model", None, None)}
        if "bq" in params["shared"]["attn"]:
            b1 = P() if kv_rep > 1 else P("model", None)
            sh_attn.update(bq=P("model", None), bk=b1, bv=b1)
        specs = {k: P() for k in params}
        specs["shared"] = {"attn": sh_attn, "ln1": P(), "ln2": P(),
                           "mlp": dict(_MLP_SPECS)}
        if ssm_tp:
            specs["layers"] = {"mamba": _mamba_param_specs(), "ln": P()}
        return specs
    h = P(None, None, "model", None)                 # [L, d, H, hd]
    attn = {"wq": h, "wk": kvw, "wv": kvw,
            "wo": P(None, "model", None, None)}      # [L, H, hd, d]
    if "bq" in params["layers"]["attn"]:
        attn.update(bq=P(None, "model", None), bk=kvb, bv=kvb)
    layer = {"attn": attn, "ln1": P(), "ln2": P()}
    if cfg.family == "moe":
        e = P(None, "model", None, None)             # [L, E, d|f, f|d]
        layer["moe"] = {"router": P(), "wi_gate": e, "wi_up": e, "wo": e}
    else:
        layer["mlp"] = {"wi_gate": P(None, None, "model"),
                        "wi_up": P(None, None, "model"),
                        "wo": P(None, "model", None)}
    specs = {k: P() for k in params}
    specs["layers"] = layer
    if vocab_sharded and "lm_head" in params:
        specs["lm_head"] = {k: P(None, "model") if k == "w" else P("model")
                            for k in params["lm_head"]}
    return specs


def mlp_decode_manual(mp, x):
    """SwiGLU MLP on a d_ff column shard + row-parallel wo + psum over
    ``model``.  x [B, S, d]."""
    return C.psum(L.mlp_apply(mp, x), "model")


def logits_decode_manual(cfg, params, x, *, vocab_sharded: bool):
    """Read-out on a rank: tied embeddings are replicated; an untied head
    vocab-sharded over ``model`` is all-gathered along the vocab dim."""
    if cfg.tie_embeddings:
        return nn.embed_logits(params["embed"], x)
    y = nn.dense(params["lm_head"], x)
    if vocab_sharded:
        y = C.all_gather(y, "model", dim=-1, tiled=True)
    return y


def attn_apply_tp(cfg, p, x, positions, *, window: int = 0,
                  mrope_positions=None):
    """Attention sublayer with residual: x + attn(rmsnorm(ln1, x)).  ``p``
    is the layer's params (this rank's shards when the manual path
    applies to an attention sublayer, see ``block_param_specs``)."""
    rules = ctx.current_rules()
    if not _manual_tp(cfg, rules, need_ff=False):
        h = L.self_attention(p["attn"], nn.norm(cfg, p["ln1"], x),
                             positions, cfg, window=window,
                             mrope_positions=mrope_positions)
    else:
        h = _attn_manual(cfg, p["attn"], p["ln1"], x, positions, window,
                         mrope_positions)
    return x + nn.residual(cfg, h)


def block_apply_tp(cfg, p, x, positions, *, window: int = 0,
                   mrope_positions=None):
    """Full pre-norm (attn + MLP) block, TP'd per ``cfg.tp_impl``: on the
    manual path ``p`` holds this rank's shards (``block_param_specs``) and
    ``x`` its batch piece (``batch_spec``), and the result is that piece."""
    rules = ctx.current_rules()
    if not _manual_tp(cfg, rules, need_ff=True):
        return L.block_apply(p, x, positions, cfg, window=window,
                             mrope_positions=mrope_positions)
    h = _attn_manual(cfg, p["attn"], p["ln1"], x, positions, window,
                     mrope_positions)
    x = x + nn.residual(cfg, h)
    return x + nn.residual(cfg, _mlp_manual(cfg, p["mlp"], p["ln2"], x))
