"""The port's mesh layer without processes: ``dist/sharding`` (spec
resolution, the rule tables, ``param_axes``, ``local_shard``),
``dist/ctx``, the decode gates of ``dist/tp`` and the engine's fallback
strings, each against the JAX package's on the same abstract meshes."""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_smoke_config as j_smoke
from repro.dist import ctx as j_ctx
from repro.dist import sharding as JSH
from repro.dist import tp as JTP
from repro.models.registry import get_model as j_get_model
from repro.serving import engine as JEG
from repro_torch.configs import get_smoke_config
from repro_torch.dist import collectives as C
from repro_torch.dist import ctx
from repro_torch.dist import sharding as SH
from repro_torch.dist import tp as TP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import convert
from repro_torch.serving import engine as EG
from repro_torch.serving import paged

ARCHS = sorted(J_ARCH_IDS)
TABLES = ("train_rules", "serve_rules", "serve_manual_rules", "dp_rules")
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes(shape, axes):
    return AbstractMesh(shape, axes), C.AbstractMesh(shape, axes)


def _fake(shape=(2, 4), axes=("data", "model")):
    rules = {"batch": ("pod", "data"), "heads": ("model",),
             "kv": ("model",), "embed": ("data",), "vocab": ("model",)}
    jm, tm = _meshes(shape, axes)
    return (JSH.ShardingRules(mesh=jm, rules=rules),
            SH.ShardingRules(mesh=tm, rules=rules))


# (logical axes, shape, exclude) of tests/test_dist.py's spec cases
SPEC_CASES = [
    (("batch", "heads"), (6, 6), frozenset()),
    (("batch", "heads"), (6, 8), frozenset()),
    (("batch",), (8,), frozenset()),
    (("heads", "kv"), (8, 8), frozenset()),
    (("batch", "heads"), (6, 8), frozenset({"data"})),
    (("embed", "vocab", None), (4, 12, 3), frozenset()),
]


@pytest.mark.parametrize("logical,shape,exclude", SPEC_CASES)
def test_spec_matches_reference(logical, shape, exclude):
    jr, tr = _fake()
    want = jr.spec(logical, shape, exclude=exclude)
    got = tr.spec(logical, shape, exclude=exclude)
    assert isinstance(got, SH.P)
    assert tuple(got) == tuple(want)
    assert tuple(tr.drop("model").spec(logical, shape)) == \
        tuple(jr.drop("model").spec(logical, shape))


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("mesh", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_rule_tables_match_reference(table, mesh):
    """``axis_for`` of every logical name of every table, on every mesh,
    at sizes that divide some axis products and not others."""
    jm, tm = _meshes(*mesh)
    jr, tr = getattr(JSH, table)(jm), getattr(SH, table)(tm)
    assert tr.mode == jr.mode and tr.rules == jr.rules
    names = sorted(set(jr.rules) | {"layer", "qk_head"}) + [None]
    for name in names:
        for size in (1, 2, 3, 4, 6, 8, 12, 16, 48, 256, 512, 152064):
            assert tr.axis_for(name, size) == jr.axis_for(name, size), \
                (name, size)
    for ax in (paged.POOL_AXES, paged.POOL_AXES_TP, paged.POOL_SCALE_AXES_TP):
        for shp in ((4, 64, 16, 8, 128), (4, 96, 16, 2, 8), (2, 8, 4, 1, 8)):
            assert tuple(tr.spec(ax, shp[:len(ax)])) == \
                tuple(jr.spec(ax, shp[:len(ax)]))


def test_axis_for_experts_contract():
    jm, tm = _meshes((2, 4), ("data", "model"))
    for E in (8, 6, 4):
        assert SH.train_rules(tm).axis_for("experts", E) == \
            JSH.train_rules(jm).axis_for("experts", E)
        assert SH.dp_rules(tm).axis_for("experts", E) is None


def test_tree_specs_handle_scalars_and_tuples():
    jr, tr = _fake()
    axes = {"w": ("embed", "heads"), "step": (), "nested": {"b": None}}
    shapes = {"w": (4, 4), "step": (), "nested": {"b": (3,)}}
    sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                       shapes, is_leaf=lambda x: isinstance(x, tuple))
    want = jr.tree_specs(axes, sds)
    got = tr.tree_specs(axes, shapes)
    for k in ("w", "step"):
        assert tuple(got[k]) == tuple(want[k])
    assert tuple(got["nested"]["b"]) == tuple(want["nested"]["b"]) == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    """``param_axes`` of the port's parameter tree is the reference's
    logical-axes tree (what the gspmd layout cuts the weights by)."""
    jc = j_smoke(arch)
    jp, ja = j_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = convert.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                 get_smoke_config(arch), "cpu")
    got = SH.param_axes(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(
        ja, is_leaf=JSH._is_axes_leaf)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(got))
    for path, ax in flat_j:
        node = got
        for k in path:
            node = node[k.key]
        assert node == ax, (path, node, ax)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


class _Rank:
    """A mesh seen from one rank: its axis sizes and coordinates."""

    def __init__(self, shape, axes, rank):
        self.shape = dict(zip(axes, shape))
        self.coords = {}
        for a in reversed(axes):
            self.coords[a] = rank % self.shape[a]
            rank //= self.shape[a]


@pytest.mark.parametrize("spec", [SH.P(), SH.P("data"), SH.P(None, "model"),
                                  SH.P(("pod", "data"), "model"),
                                  SH.P(None, ("pod", "data", "model"))])
def test_local_shard_pieces_tile_the_full_array(spec):
    """Every rank's piece (numpy and tensor leaves, under a prefix spec)
    put back at its place rebuilds the full array exactly once."""
    import torch
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    full = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    cover = np.zeros_like(full)
    for r in range(8):
        mesh = _Rank(shape, axes, r)
        tree = {"a": full, "b": {"c": torch.from_numpy(full)}}
        out = SH.local_shard(tree, {"a": spec, "b": spec}, mesh)
        sl = SH.shard_slices(spec, full.shape, mesh)
        np.testing.assert_array_equal(out["a"], full[sl])
        assert out["a"].flags["C_CONTIGUOUS"]
        t = out["b"]["c"]
        assert t.is_contiguous() and t.untyped_storage().data_ptr() != \
            tree["b"]["c"].untyped_storage().data_ptr()
        np.testing.assert_array_equal(t.numpy(), full[sl])
        cover[sl] += 1
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= dict(zip(axes, shape))[a]
    np.testing.assert_array_equal(cover, np.full_like(full, 8 // n))


def _gate_cfgs(arch, impl):
    over = dict(tp_impl=impl, fused_kernel=True)
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_gates_match_reference(arch):
    """The manual-decode gates, the KV replication factor, the mamba
    head-sharding gate, the megastep tag and the engine's reason strings
    (``_manual_decode_reason``, ``fallback_report``) for tp in {1, 2, 4,
    8, 16}, on both decode rule sets."""
    for impl in ("manual", "gspmd"):
        jc, tc = _gate_cfgs(arch, impl)
        for tp in (1, 2, 4, 8, 16):
            jm, tm = _meshes((2, tp), ("data", "model"))
            assert TP.decode_kv_rep(tc, tp) == JTP.decode_kv_rep(jc, tp)
            assert TP.decode_ssm_tp(tc, tp) == JTP.decode_ssm_tp(jc, tp)
            for table in ("serve_rules", "serve_manual_rules"):
                jr = getattr(JSH, table)(jm)
                tr = getattr(SH, table)(tm)
                assert TP.decode_manual_unsupported(tc, tr) == \
                    JTP.decode_manual_unsupported(jc, jr)
                assert TP.decode_manual_tp(tc, tr) == \
                    JTP.decode_manual_tp(jc, jr)
                assert EG._manual_decode_reason(tc, tr) == \
                    JEG._manual_decode_reason(jc, jr)
                assert EG.fallback_report(tc, tr) == \
                    JEG.fallback_report(jc, jr)
                for K in (1, 8):
                    assert TP.decode_megastep_mode(tc, tr, K) == \
                        JTP.decode_megastep_mode(jc, jr, K)
        assert TP.decode_manual_unsupported(tc, None) == \
            JTP.decode_manual_unsupported(jc, None)
        assert EG.fallback_report(tc) == JEG.fallback_report(jc)


def test_fallback_report_strings_match_reference():
    """``fallback_report(cfg, rules)`` on the kv_rep > 1 layout, with the
    fused kernel off, and under every probe strategy."""
    jm, tm = _meshes((2, 4), ("data", "model"))
    for strategy in ("linear", "robinhood", "hopscotch"):
        for fused in (True, False):
            over = dict(tp_impl="manual", fused_kernel=fused,
                        probe_strategy=strategy)
            jc = dataclasses.replace(j_smoke("qwen2.5-32b"), **over)
            tc = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                                     **over)
            got = EG.fallback_report(tc, SH.serve_manual_rules(tm))
            assert got == JEG.fallback_report(jc,
                                              JSH.serve_manual_rules(jm))
    assert got["fused_kernel"] == "off (cfg.fused_kernel=False)"


def test_use_rules_nesting_and_restore():
    tm = C.AbstractMesh((1, 1), ("data", "model"))
    r1, r2 = SH.train_rules(tm), SH.serve_rules(tm)
    assert ctx.current_rules() is None
    with ctx.use_rules(r1):
        assert ctx.current_rules() is r1
        with ctx.use_rules(r2):
            assert ctx.current_rules() is r2
            with ctx.use_rules(None):
                assert ctx.current_rules() is None
            assert ctx.current_rules() is r2
        assert ctx.current_rules() is r1
    assert ctx.current_rules() is None
    with pytest.raises(RuntimeError):
        with ctx.use_rules(r1):
            with ctx.manual_axes(("model",)):
                assert ctx.current_manual_axes() == {"model"}
                raise RuntimeError("boom")
    assert ctx.current_rules() is None
    assert ctx.current_manual_axes() == frozenset()
    assert j_ctx.current_rules() is None


def test_shard_act_checks_the_local_shape():
    """Identity without rules; under rules the tensor must be the local
    piece the rules cut from ``full_shape``."""
    import torch
    _, tr = _fake()
    x = torch.ones((3, 2, 16))
    assert ctx.shard_act(x, ("batch", None, None)) is x
    with ctx.use_rules(tr):
        assert ctx.shard_act(x, ("batch", None, "vocab"),
                             full_shape=(6, 2, 64)) is x
        with pytest.raises(ValueError, match="local shape"):
            ctx.shard_act(x, ("batch", None, None), full_shape=(12, 2, 16))


def test_production_mesh_is_shape_only():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert m.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                           else {"data": 16, "model": 16})
        assert m.size == (512 if multi else 256)
