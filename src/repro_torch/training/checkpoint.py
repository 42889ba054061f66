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

* **Mesh-agnostic / elastic restore** — leaves are stored whole, keyed by
  tree path, with their *logical axes* in the manifest (``state_axes``).
  ``restore(..., rules=)`` cuts every leaf with a recorded axes list by
  ``rules.spec`` for this rank (``sharding.shard_slices``, reading only
  that slice of the file) and places it on the rank's device: a state
  saved from one mesh shape restores onto another, or onto one device,
  and the reference reads it too.
* **Save from a mesh** — ``save(..., rules=)`` gathers each sharded
  leaf's pieces to rank 0 (every rank takes part), which puts them in
  place by the ranks' coordinates and writes the reference's layout; the
  other ranks wait on the atomic commit (a barrier).

Without ``rules`` every leaf returns to the device of the template's leaf.
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


def _axes_leaf(x) -> bool:
    """A logical-axes tuple (``("vocab", "embed")``, ``()``) is a leaf of
    the axes tree."""
    return type(x) is tuple and all(e is None or isinstance(e, str)
                                    for e in x)


def _flatten_axes(axes_tree, prefix: str = "") -> dict:
    if axes_tree is None or _axes_leaf(axes_tree):
        return {prefix: axes_tree}
    flat = {}
    for k, child in _items(axes_tree):
        flat.update(_flatten_axes(child, f"{prefix}/{k}" if prefix else k))
    return flat


def _write_leaves(tmp: str, tree, manifest: dict, state_axes=None) -> None:
    ax_flat = _flatten_axes(state_axes) if state_axes is not None else {}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        entry = {"file": fname, "shape": list(arr.shape), "dtype": dtype}
        if key in ax_flat:
            ax = ax_flat[key]
            entry["logical_axes"] = list(ax) if isinstance(ax, tuple) \
                else None
        manifest["leaves"][key] = entry
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


def gather_state(state, specs, rules):
    """The whole value of every leaf of a rank's sharded ``state`` on the
    host, on rank 0 (None on the others): each leaf cut by its spec in
    ``specs`` (a tree of ``sharding.P`` like ``state``, e.g.
    ``train_step.state_specs``) is gathered to rank 0, every rank's piece
    once (``collectives.gather_to_root``), and put in place by the rank's
    coordinates — a collective every rank joins, leaf by leaf in the same
    order."""
    import types
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import P, shard_slices

    def flat_specs(tree, prefix=""):
        if isinstance(tree, P):
            return {prefix: tree}
        out = {}
        for k, child in _items(tree):
            out.update(flat_specs(child, f"{prefix}/{k}" if prefix else k))
        return out

    spec_flat = flat_specs(specs)
    mesh = rules.mesh
    rank0 = mesh.rank == 0

    def full(key, leaf):
        spec = spec_flat.get(key)
        if not (isinstance(leaf, torch.Tensor) and spec):
            return _host(leaf) if rank0 else None
        pieces = C.gather_to_root(leaf)
        if not rank0:
            return None
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        shape = tuple(n * rules.mesh_size(e) for n, e in
                      zip(leaf.shape, spec))
        whole = torch.empty(shape, dtype=leaf.dtype)
        for r, piece in enumerate(pieces):
            at = types.SimpleNamespace(shape=mesh.shape,
                                       coords=mesh.coords_of(r))
            whole[shard_slices(spec, shape, at)] = piece
        return whole

    out = _unflatten(state, full)
    return out if rank0 else None


def save(ckpt_dir: str, step: int, state, state_axes=None,
         extra: Optional[dict] = None, *, rules=None, specs=None) -> str:
    """Atomic checkpoint of a tree of tensors / arrays.  Returns the
    committed path.  ``state_axes`` (the logical axes of the leaves, e.g.
    ``train_step.state_axes``) are recorded for elastic restore.  With
    ``rules`` ``state`` holds this rank's shards, cut by ``specs``: every
    rank gathers, rank 0 writes, and all return the path once it is
    committed.

    A step that is already committed keeps its LEAVES untouched: training
    is restart-deterministic (batches are a pure function of step), so the
    state at a given step is content-identical.  The ``extra`` METADATA can
    change between re-saves of the same step (the shard manifest after an
    elastic remesh), so a re-save merges the new ``extra`` into the
    committed manifest atomically instead of dropping it."""
    if rules is not None:
        host = gather_state(state, specs, rules)
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        err = None
        if host is not None:
            try:
                path = save(ckpt_dir, step, host, state_axes, extra)
            except BaseException as e:      # raised after the barrier
                err = e
        _barrier()
        if err is not None:
            raise err
        return path
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
                               "extra": extra or {}}, state_axes)
    os.rename(tmp, final)          # the atomic commit point
    return final


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d.split("_")[1].isdigit()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, state_template, *, step: Optional[int] = None,
            rules=None) -> Tuple[Any, int]:
    """Restore into the template's structure: each leaf as a tensor on the
    template leaf's device (with its ``requires_grad``).  With ``rules``
    (the sharding rules of this rank's mesh) a leaf with recorded logical
    axes is cut to this rank's piece of ``rules.spec`` — elastic restore
    onto another mesh shape — and lands on the mesh's device."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key, tmpl):
        entry = manifest["leaves"][key]
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        dev = tmpl.device if isinstance(tmpl, torch.Tensor) else None
        if rules is not None and entry.get("logical_axes") is not None:
            from repro_torch.dist.sharding import shard_slices
            spec = rules.spec(tuple(entry["logical_axes"]), arr.shape)
            arr = arr[shard_slices(spec, arr.shape, rules.mesh)]
            dev = rules.mesh.device
        if arr.dtype.kind == "V":    # the reference's bf16 (ml_dtypes)
            arr = np.asarray(arr).view(np.uint16)
        t = _from_numpy(np.array(arr), entry["dtype"])
        if dev is not None:
            t = t.to(dev)
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
    """keep-N rotation + async disk writes.  With ``rules`` (a mesh's
    sharding rules) and ``specs`` (how the saved state is cut) every rank
    calls ``save_async`` and ``wait`` at the same points: the gather is
    collective, rank 0 alone writes, and ``wait`` ends in a barrier, so
    no rank reads a step before its commit."""

    def __init__(self, ckpt_dir: str, keep: int = 3, rules=None,
                 specs=None):
        self.dir = ckpt_dir
        self.keep = keep
        self.rules = rules
        self.specs = specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False

    def save_async(self, step: int, state, state_axes=None) -> None:
        if self.rules is not None:
            host_state = gather_state(state, self.specs, self.rules)
        else:
            host_state = _unflatten(state, lambda _, leaf: _host(leaf))
        self.wait()
        self._pending = True
        if host_state is None:          # a rank other than 0 on a mesh
            return

        def _write():
            try:
                save(self.dir, step, host_state, state_axes)
                prune(self.dir, self.keep)
            except BaseException as e:    # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write (on a mesh, then meet every rank at a
        barrier); raises what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and self.rules is not None:
            _barrier()
        self._pending = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template, rules=None):
        return restore(self.dir, template, rules=rules)
