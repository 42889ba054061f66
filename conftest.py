"""The order in which ``pytest -n N --dist loadfile`` hands out test files.

xdist gives each worker whole files, those with the most tests first.  A
test count is a poor guess at a file's cost here: the costliest files hold
few tests (8-device subprocesses, storms of many rounds, property tests
over dozens of examples), so they went out last and the run waited on
them.  Here the files of ``SLOWEST_FIRST`` go out first, in its order, and
the rest follow, those with the most tests first.  Only when each file
starts changes, not what any test does; a run without xdist keeps
pytest's own order."""
import collections

# the costliest files first: seconds of test time each, summed from
# `--durations=0` of one 6-worker run on an 8-core host
SLOWEST_FIRST = (
    "tests/test_serving.py",                    # 1041
    "tests/test_probe_strategies.py",           # 599
    "tests/test_sharded_table.py",              # 470
    "tests/test_torch_sharded_table.py",        # 428
    "tests/test_batched.py",                    # 425
    "tests/test_torch_mesh.py",                 # 342
    "tests/test_mesh.py",                       # 286
    "tests/test_simulator.py",                  # 259
    "tests/test_torch_mesh_train.py",           # 198
    "tests/test_torch_tooling.py",              # 182
    "tests/test_models.py",                     # 181
    "tests/test_archs.py",                      # 178
    "tests/test_kernel_fused.py",               # 175
    "tests/test_sched.py",                      # 167
    "tests/test_torch_strategies.py",           # 158
    "tests/test_torch_serve.py",                # 155
)


def pytest_configure(config):
    # the controller: queue the files in the workers' collection order
    if config.getoption("dist", "no") == "loadfile":
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    if not hasattr(config, "workerinput"):      # not an xdist worker
        return
    file_of = {id(i): i.nodeid.split("::", 1)[0] for i in items}
    n_tests = collections.Counter(file_of.values())
    rank = {f: r for r, f in enumerate(SLOWEST_FIRST)}
    items.sort(key=lambda i: (rank.get(file_of[id(i)], len(rank)),
                              -n_tests[file_of[id(i)]]))
