"""Logical-axis -> mesh-axis sharding rules (PyTorch port of
``dist/sharding.py``).

Every parameter and state tensor carries logical axis names (``PARAM_AXES``
below for the parameters, the engine's state axes for the decode state).
A ``ShardingRules`` instance maps those names onto the axes of a mesh,
divisibility-aware: a mapping applies only when the dim size is divisible
by the mapped mesh-axis product, so the same rule tables drive the
production mesh and a 2x2 test mesh (non-dividing dims stay replicated).

``spec`` gives a ``P`` (the reference's ``PartitionSpec``: one entry per
dim, a mesh axis name, a tuple of them, or None, trailing Nones dropped).
Where the reference places a global array with ``NamedSharding``, a rank
of the port holds only its piece: ``local_shard`` cuts a full tree (numpy
arrays or tensors) into this rank's pieces from a tree of specs.

Presets (the reference's tables, l.144-191): ``train_rules``,
``serve_rules`` (decode activations replicated, weights TP over
``model``, page pools over every axis, per-sequence state over ``data``),
``serve_manual_rules`` (pages over (pod, data) only, KV heads over
``model``) and ``dp_rules``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Rules = Dict[str, Tuple[str, ...]]


class P(tuple):
    """PartitionSpec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _as_tuple(v) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                          # collectives.Mesh / AbstractMesh
    rules: Dict[str, Tuple[str, ...]]
    mode: str = "train"                # "train" | "serve"

    # -- core resolution --------------------------------------------------

    def axis_for(self, name: Optional[str], size: int,
                 exclude: frozenset = frozenset()):
        """Mesh axes (str for one, tuple for several, None for unmapped)
        that logical axis ``name`` shards over for a dim of ``size``."""
        if name is None:
            return None
        want = tuple(a for a in self.rules.get(name, ())
                     if a in self.mesh.shape and a not in exclude)
        picked = []
        prod = 1
        for a in want:
            n = self.mesh.shape[a]
            if size % (prod * n) != 0:
                break
            picked.append(a)
            prod *= n
        if not picked or prod == 1:
            return None
        return picked[0] if len(picked) == 1 else tuple(picked)

    def spec(self, logical: Tuple[Optional[str], ...],
             shape: Tuple[int, ...], exclude: frozenset = frozenset()) -> P:
        """Spec for a value of ``shape`` annotated with ``logical`` axis
        names.  Each mesh axis is used at most once (first dim wins)."""
        logical = tuple(logical) + (None,) * (len(shape) - len(logical))
        used: set = set(exclude)
        entries = []
        for name, size in zip(logical, shape):
            got = self.axis_for(name, size, exclude=frozenset(used))
            if got is not None:
                used.update((got,) if isinstance(got, str) else got)
            entries.append(got)
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    def mesh_size(self, entry) -> int:
        n = 1
        for a in _as_tuple(entry):
            n *= self.mesh.shape[a]
        return n

    def local_shape(self, spec: P, shape: Tuple[int, ...]) -> tuple:
        """The shape of one rank's piece of a ``shape`` value under
        ``spec``."""
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(n // self.mesh_size(e) for n, e in zip(shape, spec))

    # -- tree helpers -----------------------------------------------------

    def tree_specs(self, axes_tree, shape_tree):
        """Spec tree for ``shape_tree`` (arrays, tensors or shapes) given
        the parallel logical-axes tree ``axes_tree``."""
        return _map2(lambda ax, s: self.spec(_as_tuple(ax), _shape(s)),
                     axes_tree, shape_tree)

    # -- derived rule sets ------------------------------------------------

    def drop(self, *mesh_axes: str) -> "ShardingRules":
        """A copy that never shards over ``mesh_axes``."""
        gone = set(mesh_axes)
        return ShardingRules(
            mesh=self.mesh,
            rules={k: tuple(a for a in v if a not in gone)
                   for k, v in self.rules.items()},
            mode=self.mode)


def _is_axes_leaf(x) -> bool:
    """Logical-axes leaves are plain tuples of names/None (incl. ``()`` for
    scalars) or bare None.  NamedTuples (tree nodes) are excluded."""
    return x is None or (type(x) is tuple
                         and all(e is None or isinstance(e, str) for e in x))


def _shape(s) -> Tuple[int, ...]:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


def _map2(fn, axes_tree, tree):
    """Map ``fn(axes_leaf, leaf)`` over two parallel trees (dicts and
    NamedTuples); ``axes_tree`` may be a prefix of ``tree``."""
    if _is_axes_leaf(axes_tree) or isinstance(axes_tree, P):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        return {k: _map2(fn, axes_tree[k], tree[k]) for k in tree}
    if isinstance(axes_tree, tuple):          # NamedTuple node
        return type(tree)(*(_map2(fn, a, t)
                            for a, t in zip(axes_tree, tree)))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, sorted."""
    return tuple(sorted(a for e in spec for a in _as_tuple(e)))


def shard_slices(spec, shape, mesh) -> Tuple[slice, ...]:
    """This rank's slice of each dim of a ``shape`` value under ``spec``:
    a dim sharded over axes (a, b) is cut into size(a)·size(b) pieces and
    the rank takes piece ``index_a · size(b) + index_b``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, spec):
        axes = _as_tuple(e)
        k, idx = 1, 0
        for a in axes:
            k *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coords[a]
        if n % k:
            raise ValueError(f"dim {n} not divisible over {axes}")
        w = n // k
        out.append(slice(idx * w, (idx + 1) * w))
    return tuple(out)


def local_shard(tree, specs, mesh, *, device=None):
    """Cut a full tree (numpy arrays or tensors, in dicts and NamedTuples)
    into this rank's pieces: the counterpart of ``jax.device_put(tree,
    NamedSharding(mesh, spec))`` for the rank that runs it.  ``specs`` is
    a spec tree, possibly a prefix of ``tree`` (one ``P`` covers a whole
    subtree).  A numpy leaf gives a contiguous numpy piece; a tensor leaf
    gives its own contiguous tensor (never a view of the full one), on
    ``device`` when given."""
    def cut(spec, leaf):
        if isinstance(leaf, dict):
            return {k: cut(spec, v) for k, v in leaf.items()}
        if isinstance(leaf, tuple):
            return type(leaf)(*(cut(spec, v) for v in leaf))
        piece = leaf[shard_slices(spec, _shape(leaf), mesh)]
        if isinstance(piece, torch.Tensor):
            return piece.to(device=device or piece.device, copy=True,
                            memory_format=torch.contiguous_format)
        return np.ascontiguousarray(piece)

    return _map2(cut, specs, tree)


def reshard(t: torch.Tensor, have, want) -> torch.Tensor:
    """This rank's piece of a value under spec ``want``, from its piece
    under spec ``have`` (the resharding GSPMD inserts between two
    layouts): a dim whose mesh axes differ is all-gathered over the axes
    it had, then cut over the axes it wants."""
    from repro_torch.dist import collectives as C
    mesh = C.current_mesh()
    nd = t.dim()
    have = tuple(have) + (None,) * (nd - len(have))
    want = tuple(want) + (None,) * (nd - len(want))
    for d, (h, w) in enumerate(zip(have, want)):
        if _as_tuple(h) == _as_tuple(w):
            continue
        if _as_tuple(h):
            t = C.all_gather(t, _as_tuple(h), dim=d, tiled=True)
        if _as_tuple(w):
            sl = shard_slices(P(*((None,) * d + (w,))), t.shape, mesh)
            t = t[sl].contiguous()
    return t


# ---------------------------------------------------------------------------
# The parameters' logical axes, by (parent key, leaf key), as the
# reference's ``*_init`` functions return them; a leaf under a stacked
# ``layers`` / ``encoder`` / ``decoder`` subtree gets a leading "layer".

_ATTN_AXES = {
    "wq": ("embed", "heads", "qk_head"), "wk": ("embed", "kv", "qk_head"),
    "wv": ("embed", "kv", "qk_head"), "wo": ("heads", "qk_head", "embed"),
    "bq": ("heads", "qk_head"), "bk": ("kv", "qk_head"),
    "bv": ("kv", "qk_head")}
PARAM_AXES = {
    **{("attn", k): v for k, v in _ATTN_AXES.items()},
    **{("cross", k): v for k, v in _ATTN_AXES.items()},
    ("mlp", "wi_gate"): ("embed", "mlp"), ("mlp", "wi_up"): ("embed", "mlp"),
    ("mlp", "wo"): ("mlp", "embed"),
    ("moe", "router"): ("embed", None),
    ("moe", "wi_gate"): ("experts", "embed", "mlp_shard"),
    ("moe", "wi_up"): ("experts", "embed", "mlp_shard"),
    ("moe", "wo"): ("experts", "mlp_shard", "embed"),
    ("shared", "wi_gate"): ("embed", "mlp"),
    ("shared", "wi_up"): ("embed", "mlp"),
    ("shared", "wo"): ("mlp", "embed"),
    ("mamba", "w_z"): ("embed", "ssm_inner"),
    ("mamba", "w_x"): ("embed", "ssm_inner"),
    ("mamba", "w_bc"): ("embed", None),
    ("mamba", "w_dt"): ("embed", "ssm_heads"),
    ("mamba", "conv_x_w"): ("conv", "ssm_inner"),
    ("mamba", "conv_x_b"): ("ssm_inner",),
    ("mamba", "conv_bc_w"): ("conv", None),
    ("mamba", "conv_bc_b"): (None,),
    ("mamba", "A_log"): ("ssm_heads",), ("mamba", "dt_bias"): ("ssm_heads",),
    ("mamba", "D"): ("ssm_heads",), ("mamba", "norm"): ("ssm_inner",),
    ("mamba", "w_out"): ("ssm_inner", "embed"),
    ("embed", "embedding"): ("vocab", "embed"),
    ("lm_head", "w"): ("embed", "vocab"),
    ("lm_head", "b"): ("vocab",),
}
# stacked on a leading layer axis; "mamba", "attn" and "ffn" are a
# layer_types stack's per-kind stacks (models/hybrid.py)
_STACKED = ("layers", "encoder", "decoder", "mamba", "attn", "ffn")


def param_axes(params):
    """The logical-axes tree of a parameter tree (norm scales are
    ``("embed",)``)."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        ax = PARAM_AXES.get(path[-2:], ("embed",) if path[-1] == "scale"
                            else None)
        if ax is None:
            raise KeyError(f"no logical axes for parameter {path}")
        return (("layer",) + ax) if path[0] in _STACKED else ax
    return walk(params, ())


# ---------------------------------------------------------------------------
# Rule tables.

_TP_WEIGHTS = {
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "mlp_shard": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
}


def train_rules(mesh) -> ShardingRules:
    """Training: DP over (pod, data), Megatron TP over model, FSDP of the
    embed dim over data."""
    rules: Rules = {
        "batch": ("pod", "data"),
        "embed": ("data",),
        "pages": ("pod", "data", "model"),
        **_TP_WEIGHTS,
    }
    return ShardingRules(mesh=mesh, rules=rules, mode="train")


def serve_rules(mesh) -> ShardingRules:
    """Decode: activations replicated, weights TP over model, page pools
    over every axis, per-sequence state over data."""
    rules: Rules = {
        "batch": ("data",),
        "pages": ("pod", "data", "model"),
        **_TP_WEIGHTS,
    }
    return ShardingRules(mesh=mesh, rules=rules, mode="serve")


def serve_manual_rules(mesh) -> ShardingRules:
    """Fused manual-TP decode: pages over (pod, data) only — the model axis
    shards KV *heads* instead (the ``"kv"`` rule).  Weights stay
    Megatron-TP over model; activations replicated.  When the model axis
    is wider than ``n_kv`` the engine tiles the pool/ring head dim to
    ``n_kv·rep`` (``dist/tp.decode_kv_rep``) so the same mapping
    divides."""
    rules: Rules = {
        "batch": ("data",),
        "pages": ("pod", "data"),
        **_TP_WEIGHTS,
    }
    return ShardingRules(mesh=mesh, rules=rules, mode="serve")


def dp_rules(mesh) -> ShardingRules:
    """Pure data parallel: no TP anywhere; the model axis is reused for
    FSDP weight sharding."""
    rules: Rules = {
        "batch": ("pod", "data"),
        "embed": ("model",),
        "pages": ("pod", "data", "model"),
    }
    return ShardingRules(mesh=mesh, rules=rules, mode="train")
