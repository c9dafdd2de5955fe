"""Checkpointing: a manifest and one file per leaf, step-granular resume
(port of ``repro/checkpoint/checkpoint.py``, in its layout, so that each
package reads what the other wrote).

Layout:
  <dir>/step_<n>/MANIFEST.json     {step, time, leaves: {path: {file, shape,
                                    dtype}}}
  <dir>/step_<n>/<leaf-hash>.npy   sha1 of the leaf's path, 16 hex digits
  <dir>/LATEST                     the newest complete step

A leaf's path is its keys joined by "/" (``opt/m/groups/slot0/mix/wq``),
the string the reference makes of a pytree key path.  Writes are atomic
(a temporary directory renamed into place), so a preempted save never
corrupts the restore path.  numpy has no bfloat16 here: a bf16 leaf is
saved as its uint16 bits with ``"bfloat16"`` in the manifest, and a
reference checkpoint's bf16 leaf (``ml_dtypes``' type, stored as the void
type ``|V2``) is read by viewing its bytes as uint16.  Restoring onto the
card copies each leaf in from the host; the reference's tree loader,
which reads a leaf once and broadcasts it to data-parallel replicas,
belongs to tensor parallelism (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import hashlib
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16}


def _leaves(tree, path=()) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path string, leaf) of a nested dict, in sorted key order (the
    reference's pytree order for dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def _leaf_file(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16] + ".npy"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory, step: int, tree) -> Dict[str, Any]:
    """Write a complete checkpoint atomically; returns the manifest."""
    directory = Path(directory)
    final = directory / f"step_{step}"
    tmp = directory / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": int(step), "time": time.time(), "leaves": {}}
    for path, leaf in _leaves(tree):
        fname = _leaf_file(path)
        arr = _to_numpy(leaf)
        np.save(tmp / fname, arr)
        manifest["leaves"][path] = {"file": fname, "shape": list(arr.shape),
                                    "dtype": _dtype_name(leaf)}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (directory / "LATEST").write_text(str(step))
    return manifest


def latest_step(directory) -> Optional[int]:
    f = Path(directory) / "LATEST"
    if not f.exists():
        return None
    step = int(f.read_text().strip())
    if (Path(directory) / f"step_{step}" / "MANIFEST.json").exists():
        return step
    return None


def _check_sharded(mesh, broadcast_axis):
    if mesh is not None or broadcast_axis is not None:
        raise NotImplementedError(
            "restoring through the tree loader (a mesh and a broadcast "
            "axis) belongs to tensor parallelism, not ported yet (ROADMAP "
            "Queue 1 item 13)")


def _manifest(directory: Path, step: Optional[int]):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = directory / f"step_{step}"
    return d, json.loads((d / "MANIFEST.json").read_text()), step


def _read_leaf(d: Path, meta: Dict[str, Any], path: str) -> torch.Tensor:
    arr = np.load(d / meta["file"])
    name = meta["dtype"]
    if name == "bfloat16":
        # the port's uint16 bits, or the reference's |V2 (ml_dtypes) bytes
        bits = np.array(arr, order="C").view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    elif name in _DTYPES:
        t = torch.from_numpy(np.array(arr, order="C"))
        if t.dtype != _DTYPES[name]:
            raise ValueError(f"leaf {path}: file holds {arr.dtype}, the "
                             f"manifest says {name}")
    else:
        raise ValueError(f"leaf {path}: dtype {name!r} is not one the port "
                         f"reads")
    if list(t.shape) != list(meta["shape"]):
        raise ValueError(f"leaf {path}: file shape {tuple(t.shape)}, the "
                         f"manifest says {meta['shape']}")
    return t


def load_checkpoint(directory, like, step: Optional[int] = None, *,
                    mesh=None, broadcast_axis: Optional[str] = None):
    """Restore a tree shaped as ``like`` (a nested dict of tensors: each
    leaf gives the path, shape, dtype and device the read must match).
    Returns (tree, step); the tree's tensors are new."""
    _check_sharded(mesh, broadcast_axis)
    d, manifest, step = _manifest(Path(directory), step)

    def build(t, path=()):
        if isinstance(t, dict):
            return {k: build(t[k], path + (str(k),)) for k in t}
        key = "/".join(path)
        leaf = _read_leaf(d, manifest["leaves"][key], key)
        _check_like(key, leaf, t)
        return leaf.to(t.device)

    return build(like), step


def _check_like(path: str, leaf: torch.Tensor, like: torch.Tensor):
    if leaf.shape != like.shape or leaf.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {path} is {leaf.dtype} "
                         f"{tuple(leaf.shape)}, the tree wants "
                         f"{like.dtype} {tuple(like.shape)}")


def restore_into(directory, tree, step: Optional[int] = None) -> int:
    """Copy a checkpoint into ``tree``'s own tensors, in place (their
    storage kept: a captured program stays bound to it).  Returns the
    step."""
    d, manifest, step = _manifest(Path(directory), step)
    with torch.no_grad():
        for path, dst in _leaves(tree):
            leaf = _read_leaf(d, manifest["leaves"][path], path)
            _check_like(path, leaf, dst)
            dst.copy_(leaf)
    return step


class CheckpointManager:
    """Rolling checkpoint manager keeping the last ``keep`` steps.

    Beside the weights, the manager owns the job's program store
    (``<dir>/programs``, the paper's programs-in-global-memory tier): a
    Syscore booted with it installs its programs from the store's
    exports, and ``save(..., syscore=...)`` exports any program the store
    does not hold yet (a program that cannot be exported is counted as
    skipped, with its error)."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.save_times: list = []
        self._program_store = None

    @property
    def program_store(self):
        """The ProgramStore at ``<dir>/programs``, made on first use (it
        outlives checkpoint GC: only ``step_*`` directories are rolled)."""
        if self._program_store is None:
            from repro_torch.core.program_store import ProgramStore
            self._program_store = ProgramStore(self.directory / "programs")
        return self._program_store

    def save(self, step: int, tree, syscore=None):
        t0 = time.perf_counter()
        m = save_checkpoint(self.directory, step, tree)
        if syscore is not None:
            syscore.persist(self.program_store)
        self.save_times.append(time.perf_counter() - t0)
        self._gc()
        return m

    def restore(self, like, step=None, mesh=None, broadcast_axis=None):
        return load_checkpoint(self.directory, like, step, mesh=mesh,
                               broadcast_axis=broadcast_axis)

    def restore_into(self, tree, step=None) -> int:
        return restore_into(self.directory, tree, step)

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def has_checkpoint(self) -> bool:
        return latest_step(self.directory) is not None
