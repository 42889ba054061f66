"""The suite's own rules, read from its source: a test starts a Python
subprocess only through ``tests/_subproc.py``, which caps its threads, and
names a time limit of at most ``_subproc.MAX_TIMEOUT`` seconds, so that a
hang fails its own test and not the whole run.  The JAX package's own
test files, which predate the port, keep their subprocess code: the rule
holds the port's files and every file added after them."""
import ast
import inspect
import pathlib

import _subproc

TESTS = pathlib.Path(__file__).resolve().parent
# ways to start a process without the helper
OS_SPAWNERS = ("system", "popen", "fork", "posix_spawn", "posix_spawnp")
# the reference's test files that start subprocesses their own way
REFERENCE_FILES = ("test_batched.py", "test_mesh.py")


def _constants(tree):
    """Module-level ``NAME = <number>`` assignments."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)):
            out[node.targets[0].id] = node.value.value
    return out


def _faults(path):
    tree = ast.parse(path.read_text(), str(path))
    consts = _constants(tree)
    for node in ast.walk(tree):
        where = f"{path.name}:{getattr(node, 'lineno', '?')}"
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "subprocess":
                    yield f"{where} imports subprocess"
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "subprocess":
                yield f"{where} imports from subprocess"
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "os" and (f.attr in OS_SPAWNERS
                                                or f.attr.startswith(
                                                    ("exec", "spawn")))):
                yield f"{where} calls os.{f.attr}"
            name = (f.id if isinstance(f, ast.Name) else
                    f.attr if isinstance(f, ast.Attribute) else None)
            if name != "run_python":
                continue
            kw = {k.arg: k.value for k in node.keywords}
            if "timeout" not in kw:
                yield f"{where} run_python without timeout="
                continue
            t = kw["timeout"]
            limit = (t.value if isinstance(t, ast.Constant) else
                     consts.get(t.id) if isinstance(t, ast.Name) else None)
            if not (isinstance(limit, (int, float))
                    and 0 < limit <= _subproc.MAX_TIMEOUT):
                yield (f"{where} timeout={ast.unparse(t)} is not a number "
                       f"in (0, {_subproc.MAX_TIMEOUT}]")


def test_subprocesses_go_through_the_helper():
    files = sorted(p for p in TESTS.glob("*.py")
                   if p.name not in ("_subproc.py", *REFERENCE_FILES))
    assert len(files) > 10
    faults = [f for p in files for f in _faults(p)]
    assert not faults, "\n".join(faults)
    # the helper itself: a limit with no default, threads capped
    timeout = inspect.signature(_subproc.run_python).parameters["timeout"]
    assert timeout.kind is inspect.Parameter.KEYWORD_ONLY
    assert timeout.default is inspect.Parameter.empty
    env = _subproc.env(devices=8)
    assert env["OMP_NUM_THREADS"] == "1"
    assert env["PYTHONPATH"] == _subproc.SRC
    assert env["XLA_FLAGS"] == "--xla_force_host_platform_device_count=8"
