"""Atomic, restart-safe checkpointing (PyTorch port of ``training/
checkpoint.py``), in the reference's on-disk layout: one ``.npy`` per leaf
keyed by its tree path (``params/embed/embedding``, ``opt/m/...``,
``opt/count``, ``step``), and a ``manifest.json`` of files, shapes and
dtypes.

* **Atomic commit** — state is written to ``step_<N>.tmp/`` and
  ``os.rename``d to ``step_<N>/`` only after every leaf + manifest is
  fsync'd; a crash mid-save never corrupts the latest checkpoint.
* **bfloat16 leaves** are stored as their uint16 bits (``np.save`` of a
  bf16 array needs ``ml_dtypes``, which the port does not use), with
  ``"dtype": "bfloat16"`` in the manifest; ``restore`` reads them back, and
  reads the reference's own bf16 files (numpy void records) the same way.
  A float32 checkpoint the reference writes restores as it is.
* **Async save** — ``CheckpointManager.save_async`` copies the state to
  host memory synchronously and writes to disk on a worker thread, so the
  train loop stalls only for the device->host copy.
* **Multi-host sharded checkpoints** (``save_shard`` / ``commit_sharded``,
  the sharded page table's format): each host writes only the shard it
  owns, and the step becomes visible when ``shards.json`` lands (tmp +
  ``os.replace``, so a re-commit with a new shard manifest is atomic too).

The reference's mesh-aware restore (``rules=``, re-sharding every leaf by
its logical axes) is ROADMAP item 22b; here every leaf returns to the
device of the template's leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _items(tree):
    """(key, child) pairs of a tree node in the reference's flattening
    order (dict keys sorted, NamedTuple fields in order), or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, child in items:
        flat.update(_flatten(child, f"{prefix}/{k}" if prefix else k))
    return flat


def _unflatten(template, leaf_fn, prefix: str = ""):
    """``template``'s structure with each leaf replaced by
    ``leaf_fn(key, template_leaf)``."""
    items = _items(template)
    if items is None:
        return leaf_fn(prefix, template)
    kids = {k: _unflatten(c, leaf_fn, f"{prefix}/{k}" if prefix else k)
            for k, c in items}
    if isinstance(template, dict):
        return {k: kids[str(k)] for k in template}
    if hasattr(template, "_fields"):
        return type(template)(*(kids[f] for f in template._fields))
    return type(template)(kids[str(i)] for i in range(len(template)))


def _host(leaf):
    """A leaf as a CPU tensor or numpy array (bf16 stays a torch tensor:
    numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, dtype to record)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")        # keeps 0-d leaves 0-d
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write_leaves(tmp: str, tree, manifest: dict) -> None:
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def _atomic_json(path: str, doc: dict) -> None:
    """Write/overwrite a JSON file atomically: tmp + fsync + os.replace —
    safe even when ``path`` already exists (the re-save path)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None
         ) -> str:
    """Atomic checkpoint of a tree of tensors / arrays.  Returns the
    committed path.

    A step that is already committed keeps its LEAVES untouched: training
    is restart-deterministic (batches are a pure function of step), so the
    state at a given step is content-identical.  The ``extra`` METADATA can
    change between re-saves of the same step (the shard manifest after an
    elastic remesh), so a re-save merges the new ``extra`` into the
    committed manifest atomically instead of dropping it."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        if extra:
            mpath = os.path.join(final, "manifest.json")
            with open(mpath) as f:
                manifest = json.load(f)
            merged = {**manifest.get("extra", {}), **extra}
            if merged != manifest.get("extra"):
                manifest["extra"] = merged
                _atomic_json(mpath, manifest)
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_leaves(tmp, state, {"step": int(step), "leaves": {},
                               "extra": extra or {}})
    os.rename(tmp, final)          # the atomic commit point
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_template, *, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the template's structure: each leaf as a tensor on the
    template leaf's device (with its ``requires_grad``)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key, tmpl):
        entry = manifest["leaves"][key]
        t = _from_numpy(np.load(os.path.join(path, entry["file"])),
                        entry["dtype"])
        if isinstance(tmpl, torch.Tensor):
            t = t.to(tmpl.device)
            if tmpl.requires_grad:
                t.requires_grad_(True)
        return t

    return _unflatten(state_template, load), step


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


# ---------------------------------------------------------------------------
# Multi-host sharded checkpoints (the distributed page table's format).
# Restore is shard-count-agnostic: the saved unit is raw per-shard arrays +
# the routing manifest, and the reader re-homes them onto however many
# shards the new job brings.


def save_shard(ckpt_dir: str, step: int, shard_id: int, state,
               extra: Optional[dict] = None) -> str:
    """One host's shard write: ``step_<N>/shard_<S>/`` (atomic tmp+rename;
    a re-save of the same shard replaces it).  NOT a commit — the step
    stays invisible to ``latest_sharded_step`` until ``commit_sharded``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(final, exist_ok=True)
    sdir = os.path.join(final, f"shard_{shard_id:04d}")
    tmp = sdir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_leaves(tmp, state, {"shard": int(shard_id), "leaves": {},
                               "extra": extra or {}})
    if os.path.exists(sdir):
        shutil.rmtree(sdir)
    os.rename(tmp, sdir)
    return sdir


def commit_sharded(ckpt_dir: str, step: int,
                   shard_manifest: Optional[dict] = None,
                   extra: Optional[dict] = None) -> str:
    """The commit point: enumerate the written shard dirs and land
    ``shards.json`` atomically.  ``shard_manifest`` carries the routing
    manifest (``ShardManifest.to_json`` parsed dict) so restore knows the
    prefix -> owner map the shards were written under."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    shards = sorted(d for d in os.listdir(final)
                    if d.startswith("shard_") and not d.endswith(".tmp"))
    if not shards:
        raise FileNotFoundError(f"commit_sharded({step}) with no shard dirs")
    _atomic_json(os.path.join(final, "shards.json"),
                 {"step": int(step), "shards": shards,
                  "shard_manifest": shard_manifest, "extra": extra or {}})
    return os.path.join(final, "shards.json")


def latest_sharded_step(ckpt_dir: str) -> Optional[int]:
    """Latest COMMITTED sharded step (shards.json present)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_")[1].isdigit()
             and os.path.exists(os.path.join(ckpt_dir, d, "shards.json"))]
    return max(steps) if steps else None


def restore_sharded(ckpt_dir: str, *, step: Optional[int] = None
                    ) -> Tuple[list, Optional[dict], int]:
    """Read every shard of a committed sharded step as raw arrays (no
    template — shard payloads are variable-length).  Returns
    ``([{key: array, ..., "_extra": dict} per shard], shard_manifest,
    step)`` with numpy leaves; the caller re-homes the payloads onto its
    own shard count."""
    step = latest_sharded_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(
            f"no committed sharded checkpoint in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "shards.json")) as f:
        doc = json.load(f)
    out = []
    for sdir in doc["shards"]:
        with open(os.path.join(final, sdir, "manifest.json")) as f:
            manifest = json.load(f)
        shard = {"_extra": manifest.get("extra", {})}
        for key, entry in manifest["leaves"].items():
            shard[key] = np.load(os.path.join(final, sdir, entry["file"]))
        out.append(shard)
    return out, doc.get("shard_manifest"), step


class CheckpointManager:
    """keep-N rotation + async disk writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, state) -> None:
        host_state = _unflatten(state, lambda _, leaf: _host(leaf))
        self.wait()

        def _write():
            try:
                save(self.dir, step, host_state)
                prune(self.dir, self.keep)
            except BaseException as e:    # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template):
        return restore(self.dir, template)
