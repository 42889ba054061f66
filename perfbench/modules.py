"""A configuration's model modules, found by name.

A configuration file may name its model (``"model": "<name>"``; without
the key, ``decoder``).  Two files of that name hold what belongs to the
model, so that a new architecture's cell is added as files alone:

- ``reference/<name>.py``, the plain reference (imports nothing of the
  program): ``plan(cfg)``, the weights' draws in order; ``hidden(cfg, w,
  seqs, precision)`` and ``head(cfg, w)``, the float32 forward and the
  fp8 control; ``matmul_params_per_token(cfg)``; ``paged_layers(cfg)``,
  the layers the fused decode attention K1 attends in.
- ``layouts/<name>.py``, the port's side (imports the program when
  called, never when loaded): ``model_config(cfg)``; ``params(cfg, w)``,
  the port's parameter tree from the draws; ``forward(cfg, params,
  tokens)``, the port's full-sequence forward in float32, for the CPU
  parity test; ``small(cfg)``, the CPU tests' cut of the configuration.

Both are found by file name under ``HERE``, as ``harness.reader`` finds
a metric's reader: this package's own files by import (one module object
for each, whoever imports it), another directory's by file path.  This
module imports nothing of the program.
"""
from __future__ import annotations

import importlib
import importlib.util
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
DEFAULT = "decoder"

_loaded = {}


def name(cfg: dict) -> str:
    """The configuration's model name."""
    return cfg.get("model", DEFAULT)


def reference(cfg: dict):
    """``reference/<model>.py`` of the configuration."""
    return _load("reference", name(cfg))


def layout(cfg: dict):
    """``layouts/<model>.py`` of the configuration."""
    return _load("layouts", name(cfg))


def _load(kind: str, model: str):
    path = HERE / kind / f"{model}.py"
    mod = _loaded.get(path)
    if mod is None:
        qual = f"perfbench.{kind}.{model}"
        if HERE == pathlib.Path(__file__).resolve().parent:
            # this package's own file: the module a plain import gives
            mod = importlib.import_module(qual)
        else:
            spec = importlib.util.spec_from_file_location(qual, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _loaded[path] = mod
    return mod
