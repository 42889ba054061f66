"""Fault-tolerance policies for the train loop (a copy of the JAX
package's ``dist/fault_tolerance.py``, which imports only ``time`` and
``collections``).

Gao et al.'s almost-wait-free table keeps serving while individual
processes stall or die; the training-system analogue implemented here:

- ``StepWatchdog``     — a stalled step (deadlocked collective, hung host)
  raises instead of hanging the job forever; the runner restarts from the
  last checkpoint.
- ``StragglerMonitor`` — detects chips running persistently slower than the
  fleet median and escalates ok -> straggler -> replan.
- ``elastic_plan``     — after losing hosts, pick the best mesh the
  remaining chips support; ``accum_for`` keeps the effective global batch
  via gradient accumulation.

Host-side Python — policies run between steps, never inside a step.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional, Tuple

POD_CHIPS = 256     # one pod = 16x16 chips


class WatchdogTimeout(RuntimeError):
    """A training step exceeded its deadline."""


class StepWatchdog:
    """Arm before launching a step; ``check`` after the sync point raises
    ``WatchdogTimeout`` when the step overran ``deadline_s``."""

    def __init__(self, deadline_s: float):
        self.deadline_s = float(deadline_s)
        self._armed_at: Optional[float] = None
        self._step: Optional[int] = None

    def arm(self, step: int) -> None:
        self._step = int(step)
        self._armed_at = time.monotonic()

    def check(self) -> float:
        """Elapsed seconds since ``arm``; raises on overrun, 0.0 if idle."""
        if self._armed_at is None:
            return 0.0
        elapsed = time.monotonic() - self._armed_at
        if elapsed > self.deadline_s:
            raise WatchdogTimeout(
                f"step {self._step} exceeded deadline "
                f"({elapsed:.1f}s > {self.deadline_s:.1f}s)")
        return elapsed

    def disarm(self) -> None:
        self._armed_at = None


class StragglerMonitor:
    """Per-step duration monitor.  ``observe(step, dt)`` returns:

    - ``"ok"``        — dt within ``threshold`` x the rolling median
    - ``"straggler"`` — slow step (not yet ``patience`` in a row)
    - ``"replan"``    — ``patience`` consecutive slow steps: re-shard /
      swap in a hot spare

    Slow steps are excluded from the baseline so a stalling chip cannot
    drag the median up under itself."""

    def __init__(self, threshold: float = 2.0, patience: int = 3,
                 window: int = 64, min_samples: int = 3):
        self.threshold = float(threshold)
        self.patience = int(patience)
        self.min_samples = int(min_samples)
        self._history: Deque[float] = deque(maxlen=window)
        self._consecutive = 0

    def baseline(self) -> Optional[float]:
        if len(self._history) < self.min_samples:
            return None
        ordered = sorted(self._history)
        return ordered[len(ordered) // 2]

    def observe(self, step: int, dt: float) -> str:
        base = self.baseline()
        if base is not None and dt > self.threshold * base:
            self._consecutive += 1
            if self._consecutive >= self.patience:
                self._consecutive = 0
                return "replan"
            return "straggler"
        self._consecutive = 0
        self._history.append(float(dt))
        return "ok"


def elastic_plan(n_chips: int, model_parallel: int) -> Tuple[Tuple[int, ...],
                                                             Tuple[str, ...]]:
    """Best mesh for ``n_chips`` at a fixed TP width.

    Multiple full pods -> (pod, data, model); anything else (e.g. a partial
    pod after losing a host) collapses the pod axis into data so every
    surviving chip keeps working: (data, model)."""
    if model_parallel <= 0 or n_chips % model_parallel:
        raise ValueError(f"{n_chips} chips not divisible by "
                         f"model_parallel={model_parallel}")
    if n_chips % POD_CHIPS == 0 and n_chips > POD_CHIPS \
            and POD_CHIPS % model_parallel == 0:
        pods = n_chips // POD_CHIPS
        return ((pods, POD_CHIPS // model_parallel, model_parallel),
                ("pod", "data", "model"))
    return ((n_chips // model_parallel, model_parallel), ("data", "model"))


def elastic_table_plan(manifest, lost_shard: int, *,
                       chips_per_group: int = POD_CHIPS,
                       model_parallel: int = 16):
    """The serving-side elastic recovery in one step: losing a host group
    (a) picks the best surviving mesh (``elastic_plan`` — the pod axis
    collapses when only one full pod survives) and (b) reassigns the dead
    shard's hash-prefix ranges to the survivors
    (``table_shard.ShardManifest.reassign`` — survivors keep their own
    ranges, so live sequences elsewhere are undisturbed).  Returns
    ``(new_manifest, mesh_shape, axis_names)``; re-admitting the lost
    lanes is the scheduler router's job (``sched/router.lose_host`` runs
    the recompute-preemption path).

    The two halves must agree: the mesh's surviving host-group count and
    ``new_manifest.live_shards()`` describe the same fleet."""
    new_manifest = manifest.reassign(lost_shard)
    survivors = len(new_manifest.live_shards())
    shape, names = elastic_plan(survivors * chips_per_group, model_parallel)
    return new_manifest, shape, names


def accum_for(target_batch: int, actual: int) -> int:
    """Gradient-accumulation steps keeping effective batch >= target after
    an elastic resize shrank the per-step batch to ``actual``."""
    if actual <= 0:
        raise ValueError("actual batch must be positive")
    return max(1, -(-target_batch // actual))
