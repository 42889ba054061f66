"""The port's dry-run tooling and examples on the CPU, against the JAX
package where it has a counterpart.

- ``launch/flops_model``: ``executed_flops`` (every term) and
  ``executed_bytes_per_chip`` equal to the reference's for every arch x
  shape, exactly (the same arithmetic); ``launch/roofline.model_flops``
  likewise;
- the dry-run's per-rank parameter bytes for every arch x shape kind equal
  the sum of the local shapes of the reference's ``ShardingRules.spec`` on
  ``jax.sharding.AbstractMesh((16, 16), ("data", "model"))`` under the
  cell's rule choice (the reference's ``_manual_decode_ok`` gate);
- the collective counts the dry-run writes against ``COLLECTIVE_STATS``
  of real steps at smoke size on gloo ranks (bodies in
  ``tests/_torch_mesh_train_ranks.py``): the analytic decode count for the
  families and both layouts, the analytic and the recorded (``meta``)
  train count, and the prefill's recorded count against its analytic one;
- one dry-run cell end to end through the CLI (its JSON artifact);
- each example at smoke size on the CPU (``train_lm`` with ``--steps``
  cut, so only finiteness is asserted: its loss-decrease check needs the
  default 300 steps).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_mesh_train_ranks as R
from _subproc import run_python
from repro.configs import ARCH_IDS, get_config as j_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.dist import sharding as JSH
from repro.launch import flops_model as JFM
from repro.launch import roofline as JRL
from repro.models.registry import get_model as j_get_model
from repro.serving import engine as JEG
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.dist import collectives as C
from repro_torch.launch import dryrun as DR
from repro_torch.launch import flops_model as FM
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import run_spmd

# about three times the subprocesses' times on an 8-core host under six
# test workers: the dry-run CLI's 20 s, the slowest example's 22 s
DRYRUN_TIMEOUT_S = 60
EXAMPLE_TIMEOUT_S = 90


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_flops_model_equals_reference(arch):
    jc, tc = j_config(arch), get_config(arch)
    for name in sorted(J_SHAPES):
        js, ts = J_SHAPES[name], SHAPES[name]
        assert dataclasses.asdict(FM.executed_flops(tc, ts)) == \
            dataclasses.asdict(JFM.executed_flops(jc, js)), name
        for chips, tp in ((256, 16), (512, 16), (8, 2)):
            assert FM.executed_bytes_per_chip(tc, ts, chips, tp) == \
                JFM.executed_bytes_per_chip(jc, js, chips, tp), (name, chips)
        assert RL.model_flops(tc, ts) == JRL.model_flops(jc, js), name


def _ref_param_bytes(cfg, kind, jm):
    """The reference's placement: its rules' spec of every parameter's
    logical axes on the abstract mesh, summed over the local shapes."""
    box = {}

    def init(k):
        p, a = j_get_model(cfg).init(cfg, k)
        box["axes"] = a
        return p
    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    if kind == "decode":
        man = JSH.serve_manual_rules(jm)
        rules = man if JEG._manual_decode_ok(cfg, man) \
            else JSH.serve_rules(jm)
    else:
        rules = JSH.train_rules(jm)
    total = 0
    for s, ax in zip(jax.tree.leaves(sds), jax.tree.leaves(
            box["axes"], is_leaf=JSH._is_axes_leaf)):
        spec = tuple(rules.spec(ax, s.shape))
        spec = spec + (None,) * (len(s.shape) - len(spec))
        n = 1
        for dim, e in zip(s.shape, spec):
            k = 1
            for a in ((e,) if isinstance(e, str) else (e or ())):
                k *= jm.shape[a]
            n *= dim // k
        total += n * s.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_dryrun_param_bytes_equal_reference_specs(arch):
    jm = AbstractMesh((16, 16), ("data", "model"))
    tm = C.AbstractMesh((16, 16), ("data", "model"))
    jc, tc = j_config(arch), get_config(arch)
    for kind, shape in (("train", SHAPES["train_4k"]),
                        ("decode", SHAPES["decode_32k"])):
        rules, _ = DR.cell_rules(tc, shape, tm)
        assert DR.param_bytes_per_chip(tc, rules) == \
            _ref_param_bytes(jc, kind, jm), (arch, kind)


DECODE_CASES = {
    "dense_gspmd": ("qwen2.5-32b", "serve_rules", (4, 2), ("data", "model")),
    "dense_manual": ("qwen2.5-32b", "serve_manual_rules", (2, 2, 2),
                     ("pod", "data", "model")),
    "kv_rep_manual": ("qwen2.5-32b", "serve_manual_rules", (2, 4),
                      ("data", "model")),
    "moe_gspmd": ("granite-moe-1b-a400m", "serve_rules", (2, 4),
                  ("data", "model")),
    "moe_manual": ("granite-moe-1b-a400m", "serve_manual_rules", (4, 2),
                   ("data", "model")),
    "gemma3_gspmd": ("gemma3-12b", "serve_rules", (4, 2), ("data", "model")),
    "gemma3_manual": ("gemma3-12b", "serve_manual_rules", (2, 2, 2),
                      ("pod", "data", "model")),
    "vlm_gspmd": ("qwen2-vl-7b", "serve_rules", (4, 2), ("data", "model")),
    "mamba2": ("mamba2-2.7b", "serve_rules", (2, 2, 2),
               ("pod", "data", "model")),
    "zamba2_gspmd": ("zamba2-1.2b", "serve_rules", (4, 2),
                     ("data", "model")),
    "zamba2_manual": ("zamba2-1.2b", "serve_manual_rules", (4, 2),
                      ("data", "model")),
    "encdec": ("seamless-m4t-large-v2", "serve_rules", (4, 2),
               ("data", "model")),
}


def test_decode_collective_count_equals_a_real_step():
    outs = run_spmd(R.decode_step_rank, 8, (DECODE_CASES,))
    for name in DECODE_CASES:
        for o in outs:
            assert o[name]["counted"] == o[name]["real"], (
                name, o[name]["counted"], o[name]["real"])
        assert outs[0][name]["real"], name


def test_train_collective_count_equals_a_real_step():
    outs = run_spmd(R.train_step_rank, 8, ((2, 2, 2),
                                           ("pod", "data", "model")))
    for o in outs:
        assert o["counted"] == o["real"], (o["counted"], o["real"])
        assert o["recorded"] == o["real"], (o["recorded"], o["real"])
        assert o["prefill"][0] == o["prefill"][1], o["prefill"]


def test_dryrun_cli_writes_a_cell(tmp_path):
    out = run_python(
        ["-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-1b-a400m", "--shape", "decode_32k", "--mesh", "both",
         "--set", "tp_impl=manual", "--out", str(tmp_path)],
        timeout=DRYRUN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    for mesh in ("16x16", "2x16x16"):
        with open(tmp_path / f"granite-moe-1b-a400m__decode_32k__{mesh}"
                  ".json") as f:
            rec = json.load(f)
        assert rec["status"] == "ok", rec
        assert rec["collectives_source"] == "analytic"
        assert rec["decode_tp"] == "manual-fused"
        rl = rec["roofline"]
        assert rl["collective_wire_bytes"] > 0 and rl["card"] == RL.CARD
        assert rl["chips"] == (512 if mesh == "2x16x16" else 256)


FUSED = ["--set", "tp_impl=manual", "--set", "fused_kernel=1"]


@pytest.mark.parametrize("arch,sets,gates,rc", [
    # 32 KV heads over the 16-way model axis: the fused manual layout
    # with K1 on every rank
    ("codeqwen1.5-7b", FUSED, ("--expect-fused", "--expect-fused-kernel"),
     0),
    # gspmd by default: expected fused, falls back
    ("granite-moe-1b-a400m", [], ("--expect-fused",), 1),
    # 8 KV heads over 16: replicated KV keeps the two-dispatch path
    ("granite-moe-1b-a400m", FUSED, ("--expect-fused-kernel",), 1),
    # an expected arch with no ok decode cell fails, not passes vacuously
    ("codeqwen1.5-7b", FUSED + ["--shape", "train_4k"],
     ("--expect-fused",), 1),
])
def test_dryrun_expect_fused_gates(tmp_path, arch, sets, gates, rc):
    """The reference's CI gates: exit 0 when every expected arch's decode
    cells take the fused path, 1 on a quiet fallback or a vacuous gate."""
    argv = ["--arch", arch, "--out", str(tmp_path)] + sets
    if "--shape" not in argv:
        argv += ["--shape", "decode_32k"]
    for g in gates:
        argv += [g, arch]
    assert DR.main(argv) == rc


EXAMPLES = {
    "quickstart": [],
    "serve_paged": [],
    "distributed_dht": [],
    "train_lm": ["--steps", "6", "--batch", "2", "--seq", "32"],
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name):
    out = run_python(["-m", f"repro_torch.examples.{name}", "--device",
                      "cpu"] + EXAMPLES[name], timeout=EXAMPLE_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"{name} OK" in out.stdout or "quickstart OK" in out.stdout
