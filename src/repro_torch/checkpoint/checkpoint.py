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

Leaves move between the card and their files on ``_IO_THREADS`` threads,
one leaf a thread, each a ``_CHUNK`` at a time through a staging buffer
of its own (page-locked for a card's leaf): a leaf is never held whole
on the host, and a file is ``np.save``'s bytes of the leaf.  The threads
copy after the caller's current streams have drained, and every copy
has ended when a save or a restore returns.
"""
from __future__ import annotations

import collections
import hashlib
import json
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16}
# leaves in flight at once (file I/O and copies release the interpreter
# lock), and the bytes a thread stages at a time
_IO_THREADS = 4
_CHUNK = 64 << 20


def _leaves(tree, path=()) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path string, leaf) of a nested dict, in sorted key order (the
    reference's pytree order for dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


def _pipelined(fn: Callable, items: Iterable) -> Iterator:
    """``fn`` of each item on ``_IO_THREADS`` threads, the results in the
    items' order, at most ``_IO_THREADS`` calls in flight."""
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        pending = collections.deque()
        for item in items:
            if len(pending) == _IO_THREADS:
                yield pending.popleft().result()
            pending.append(pool.submit(fn, item))
        while pending:
            yield pending.popleft().result()


def _leaf_file(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16] + ".npy"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _np_dtype(t: torch.Tensor) -> np.dtype:
    """The file's dtype: a bf16 leaf is saved as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _wait_for_caller(tensors):
    """The threads copy in their own (default) streams: what the caller
    queued on its current streams comes first."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


def _chunks(flat: torch.Tensor) -> Iterator[Tuple[torch.Tensor, slice]]:
    """(stage, span) pairs covering the bytes of ``flat``: one staging
    buffer (page-locked where ``flat`` is on the card) reused for every
    span, ``stage`` cut to the span's length."""
    stage = torch.empty(max(1, min(flat.numel(), _CHUNK)), dtype=torch.uint8,
                        pin_memory=flat.is_cuda)
    for i in range(0, flat.numel(), stage.numel()):
        n = min(stage.numel(), flat.numel() - i)
        yield stage[:n], slice(i, i + n)


def _write_leaf(file: Path, leaf: torch.Tensor):
    """``np.save``'s bytes of ``leaf`` (contiguous), copied off its device
    a chunk at a time."""
    header = {"descr": np.lib.format.dtype_to_descr(_np_dtype(leaf)),
              "fortran_order": False, "shape": tuple(leaf.shape)}
    flat = leaf.reshape(-1).view(torch.uint8)
    with open(file, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        for stage, span in _chunks(flat):
            stage.copy_(flat[span])
            f.write(stage.numpy().data)


def save_checkpoint(directory, step: int, tree) -> Dict[str, Any]:
    """Write a complete checkpoint atomically; returns the manifest."""
    directory = Path(directory)
    final = directory / f"step_{step}"
    tmp = directory / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = [(path, leaf.detach().contiguous())
              for path, leaf in _leaves(tree)]
    manifest = {"step": int(step), "time": time.time(), "leaves": {
        path: {"file": _leaf_file(path), "shape": list(leaf.shape),
               "dtype": _dtype_name(leaf)} for path, leaf in leaves}}
    _wait_for_caller(leaf for _, leaf in leaves)
    for _ in _pipelined(lambda item: _write_leaf(
            tmp / _leaf_file(item[0]), item[1]), leaves):
        pass
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
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    name = meta["dtype"]
    if name == "bfloat16":
        # the port's uint16 bits, or the reference's |V2 (ml_dtypes) bytes
        bits = arr.view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    elif name in _DTYPES:
        t = torch.from_numpy(arr)
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

    def empty(t):
        return {k: empty(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.empty_like(t)

    tree = empty(like)
    return tree, restore_into(directory, tree, step)


def _check_like(path: str, leaf: torch.Tensor, like: torch.Tensor):
    if leaf.shape != like.shape or leaf.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {path} is {leaf.dtype} "
                         f"{tuple(leaf.shape)}, the tree wants "
                         f"{like.dtype} {tuple(like.shape)}")


def _read_into(d: Path, meta: Dict[str, Any], path: str,
               dst: torch.Tensor):
    """Copy a leaf's file into ``dst`` a chunk at a time.  A file whose
    header does not give ``dst``'s layout (another dtype or shape, Fortran
    order), or a ``dst`` that is not contiguous, is read whole by
    :func:`_read_leaf`, which names the mismatch."""
    dst = dst.detach()
    with open(d / meta["file"], "rb") as f:
        version = np.lib.format.read_magic(f)
        read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                       (2, 0): np.lib.format.read_array_header_2_0}.get(
                           version)
        shape, fortran, dtype = read_header(f) if read_header else \
            (None, True, None)
        # the port's uint16 bits of a bf16 leaf, or the reference's |V2
        fits = (not fortran and dst.is_contiguous()
                and list(shape) == list(meta["shape"]) == list(dst.shape)
                and meta["dtype"] == _dtype_name(dst)
                and (dtype.itemsize == 2 if dst.dtype == torch.bfloat16
                     else dtype == _np_dtype(dst)))
        if fits:
            flat = dst.view(-1).view(torch.uint8)
            for stage, span in _chunks(flat):
                if f.readinto(stage.numpy().data) != stage.numel():
                    raise ValueError(f"leaf {path}: its file ends early")
                flat[span].copy_(stage)
            return
    leaf = _read_leaf(d, meta, path)
    _check_like(path, leaf, dst)
    dst.copy_(leaf)


def restore_into(directory, tree, step: Optional[int] = None) -> int:
    """Copy a checkpoint into ``tree``'s own tensors, in place (their
    storage kept: a captured program stays bound to it).  Returns the
    step."""
    d, manifest, step = _manifest(Path(directory), step)
    leaves = list(_leaves(tree))
    _wait_for_caller(dst for _, dst in leaves)
    for _ in _pipelined(lambda item: _read_into(
            d, manifest["leaves"][item[0]], *item), leaves):
        pass
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
