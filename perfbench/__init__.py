"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, one traffic mix
or one per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py`` (the part of the metric's name before its first
dot).  The yardstick (``yardstick.py``, ``stats.py``, ``traffic.py``,
``check.py``) and the plain float32 reference (``reference/``) live
here, where the program cannot change them.
"""
