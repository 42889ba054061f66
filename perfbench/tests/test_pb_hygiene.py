"""Import hygiene and where a run may write: nothing of perfbench imports
a module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``repro`` (``repro_torch`` is another name: the whole top-level name is
compared); the reference imports nothing of ``repro_torch``; a run
loads none of them; no source names a fixed path under /tmp; the entry
point refuses to run without a card, or without the program beside it."""
import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

PB = pathlib.Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


SOURCES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_forbidden_import(path):
    tops = {m.split(".")[0] for m in imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in tops
    assert "/" + "tmp/" not in path.read_text()


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness\n"
        "from perfbench.tests import small\n"
        "out = harness.run_cell(small.cell('qwen2.5-32b.chat'), 3, 1.0, False,"
        " 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'repro'}), out['correct'])\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[] True"


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen2.5-32b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen2.5-32b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_names_only_its_own_files():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert b["paths"] == ["perfbench"]
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert (PB / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
