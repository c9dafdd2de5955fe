"""program_store — typed program specs and the global-memory program tier
(port of ``repro/core/program_store.py``).

The paper's fastest path (§3.3, Table 1) assumes programs already live in
*global memory*: installing one into the resident syscore costs a copy that
scales with the program's size, and re-execution costs a signal; only the
eSDK baseline pays the full load on every run.  The reference keeps a
serialized XLA executable on disk.  The port keeps a program's
``torch.export`` ExportedProgram (:func:`serialize_program`): the graph of
ATen and ``repro_torch::`` kernel operators that the program's Python
function runs, with the resident trees (the engine's parameters and
caches) as inputs, not constants, so a payload holds the program and not
the weights.  A rebooted :class:`~repro_torch.core.syscore.Syscore`
installs ``torch.export.load(...).module()`` in place of the Python
function (:func:`install_program`), which then never runs.  On the card
the installed program is still warmed up and captured as a CUDA graph: a
graph cannot be serialized.

Not AOTInductor: Inductor would generate new kernels in place of the
port's own operators, and every exactness rule of the port rests on those.

Two pieces:

``ProgramSpec``
    A hot-loadable program — its function, the resident trees it is bound
    to and its per-call input templates — with a stable *content
    fingerprint* that survives process reboots: the function's source and
    scalar closure cells, each resident leaf's path, shape and dtype, each
    input template's shape and dtype, and a caller-supplied ``context``
    string for anything else the closure captures (``repr(cfg)``).

``ProgramStore``
    A disk-backed map from (fingerprint, environment) to a payload,
    written atomically.  The environment is the torch and CUDA versions,
    the device (name and capability, or ``"cpu"``), the kernel library's
    source digest and the port's own source digest: a change to any of
    them invalidates every stored program.  A miss — a missing entry, a
    version skew or a corrupt payload — falls back, silently and counted,
    to running the Python function (captured on the card as before);
    programs that cannot be exported (an in-graph host call) are skipped
    and counted, never fatal.
"""
from __future__ import annotations

import contextlib
import hashlib
import inspect
import io
import itertools
import json
import os
import threading
import time
import types
import typing
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

# the repro_torch:: operators a payload calls must be registered to load it
from repro_torch.kernels import ops  # noqa: F401

_EXTRA = "repro_torch.json"     # the payload's own metadata file


# ---------------------------------------------------------------------------
# ProgramSpec
# ---------------------------------------------------------------------------
def _fn_source(fn: Callable) -> str:
    """Best-effort stable identity for ``fn``: its source text, else its
    qualified name — plus any *scalar* closure cells.

    Factory-made programs (``make_decode_horizon_step(cfg, horizon,
    eos_id)`` and friends) all share the inner def's source text, so two
    closures differing only in a captured static (a horizon length, an EOS
    id, a cache length, a ring flag) would otherwise fingerprint
    identically unless every caller remembers to fold the static into
    ``ProgramSpec.context``.  Hashing primitive cell contents
    (int/float/bool/str/bytes/None) closes that silent-collision hole;
    structured captures (config objects) remain the caller's job via
    ``context``."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        src = getattr(fn, "__qualname__", repr(fn))
    cells = getattr(fn, "__closure__", None)
    code = getattr(fn, "__code__", None)
    if cells and code is not None:
        scalars = []
        for name, cell in zip(code.co_freevars, cells):
            try:
                v = cell.cell_contents
            except ValueError:          # cell not yet filled
                continue
            if v is None or isinstance(v, (bool, int, float, str, bytes)):
                scalars.append(f"{name}={v!r}")
        if scalars:
            src += "\n# closure: " + ", ".join(scalars)
    return src


def _leaf_lines(tree, path: str):
    """One stable text line per tensor leaf of a nested dict (path, shape,
    dtype), in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_lines(tree[k], f"{path}/{k}")
    else:
        yield f"{path}:{tuple(tree.shape)}:{tree.dtype}"


@dataclass(frozen=True, eq=False)
class ProgramSpec:
    """A hot-loadable program: its key, the function, and the concrete
    arguments a capture and an export need (the port's counterpart of the
    reference's ``abstract_args``).

    A call is ``fn(*resident, *inputs)``.  ``resident`` holds the trees
    (nested dicts of tensors) every call passes first, in place, such as
    the engine's parameters and caches; ``inputs`` holds one template per
    per-call argument after them: a tensor of the shape, dtype and device
    that argument brings, 0-dim where a call passes a Python number.  The
    templates' values are what the warm-up runs on.

    ``context`` carries what the fingerprint cannot see through ``fn``:
    values the closure captures (``repr`` of the model config, the engine
    config's program context).  Equality and hashing go by fingerprint.
    """
    key: str
    fn: Callable
    resident: Tuple[Any, ...] = ()
    inputs: Tuple[torch.Tensor, ...] = ()
    context: str = ""

    def __eq__(self, other):
        return (isinstance(other, ProgramSpec)
                and self.fingerprint == other.fingerprint)

    def __hash__(self):
        return hash(self.fingerprint)

    @property
    def device(self) -> torch.device:
        """The device of the program's tensors (the first one's)."""
        for tree in (*self.resident, *self.inputs):
            for t in leaves(tree):
                return t.device
        return torch.device("cpu")

    @property
    def fingerprint(self) -> str:
        cached = getattr(self, "_fingerprint", None)
        if cached is None:
            h = hashlib.sha256()
            h.update(_fn_source(self.fn).encode())
            for i, tree in enumerate(self.resident):
                for line in _leaf_lines(tree, f"resident{i}"):
                    h.update(line.encode())
            for i, t in enumerate(self.inputs):
                h.update(f"input{i}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(self.context.encode())
            cached = h.hexdigest()
            object.__setattr__(self, "_fingerprint", cached)
        return cached


def leaves(tree):
    """A tree's leaves (a nested dict's values, or the tree itself), in
    sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


# ---------------------------------------------------------------------------
# Export and install
# ---------------------------------------------------------------------------
def _same_leaves(a, b) -> bool:
    """Whether two trees hold the same tensor objects, key for key."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_leaves(a[k], b[k])
                                            for k in a)
    return a is b


def _exportable(fn: Callable, n_resident: int,
                resident_outputs: Dict[int, int]) -> torch.nn.Module:
    """A program's function as the module ``torch.export`` traces.  The
    programs return the resident caches they wrote in place (a tree of the
    resident tensors themselves); each such output becomes ``None`` (the
    export applies the writes to the caller's tensors instead), and
    ``resident_outputs`` records which resident tree it was (a closure,
    not an attribute: the export works on a copy of the module)."""

    class Program(torch.nn.Module):
        def forward(self, *args):
            out = fn(*args)
            if not isinstance(out, tuple):
                return out
            kept = []
            for i, o in enumerate(out):
                j = next((j for j in range(n_resident)
                          if isinstance(o, dict)
                          and _same_leaves(o, args[j])), None)
                if j is None:
                    kept.append(o)
                else:
                    resident_outputs[i] = j
                    kept.append(None)
            return tuple(kept)

    return Program()


def serialize_program(spec: ProgramSpec) -> bytes:
    """``spec`` as a payload: its ``torch.export`` ExportedProgram, traced
    on fake copies of the spec's tensors (nothing runs, nothing is
    written), saved by ``torch.export.save``.  Raises where the program
    cannot be exported: an op that reads a device value on the host, or
    an in-graph host call (:meth:`HostCallTable.hostcall`)."""
    resident_outputs: Dict[int, int] = {}
    # no stack trace a node: they cost a tenth of the export and name the
    # source files of the exporting machine
    emit = getattr(torch.fx.config, "do_not_emit_stack_traces", False)
    torch.fx.config.do_not_emit_stack_traces = True
    try:
        ep = torch.export.export(
            _exportable(spec.fn, len(spec.resident), resident_outputs),
            (*spec.resident, *spec.inputs), strict=False)
    finally:
        torch.fx.config.do_not_emit_stack_traces = emit
    # the example inputs are the resident trees themselves: the weights
    # and caches stay out of the payload
    ep.example_inputs = None
    meta = {"resident_outputs": {str(i): j for i, j in
                                 resident_outputs.items()}}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_EXTRA: json.dumps(meta)})
    return buf.getvalue()


class InstalledProgram:
    """A payload installed as a callable with the program function's
    signature: ``torch.export.load(...).module()``, its per-call numbers
    made tensors of the templates' dtype and device, and the resident
    trees returned where the function returned them.  The exported module
    copies every in-place write back into the caller's tensors, so the
    program stays bound to the resident storage."""

    def __init__(self, module, n_resident: int,
                 resident_outputs: Dict[int, int],
                 templates: Tuple[torch.Tensor, ...]):
        self.module = module
        self.n_resident = n_resident
        self.resident_outputs = resident_outputs
        self.templates = templates

    def __call__(self, *args):
        n = self.n_resident
        inputs = [v if isinstance(v, torch.Tensor) else
                  torch.tensor(v, dtype=t.dtype, device=t.device)
                  for v, t in zip(args[n:], self.templates)]
        out = self.module(*args[:n], *inputs)
        if not self.resident_outputs:
            return out
        return tuple(args[self.resident_outputs[i]]
                     if i in self.resident_outputs else o
                     for i, o in enumerate(out))


@contextlib.contextmanager
def _schema_type_hints_cached():
    """torch's export deserializer asks ``typing.get_type_hints`` for the
    schema class of every object it decodes, a few hundred thousand times
    for a program of a few thousand nodes (more than half of a load's
    time, measured on the CPU).  Inside the block its module sees a
    ``typing`` whose ``get_type_hints`` remembers each class's answer;
    nothing else is touched."""
    from torch._export.serde import serialize as serde
    cache: Dict[Any, Any] = {}

    def get_type_hints(obj, globalns=None, localns=None,
                       include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in cache:
            cache[key] = typing.get_type_hints(
                obj, globalns=globalns, localns=localns,
                include_extras=include_extras)
        return cache[key]

    cached = types.SimpleNamespace(**vars(typing))
    cached.get_type_hints = get_type_hints
    if getattr(serde, "typing", None) is not typing:
        yield                   # another torch: leave its deserializer be
        return
    serde.typing = cached
    try:
        yield
    finally:
        serde.typing = typing


def install_program(payload: bytes, spec: ProgramSpec) -> InstalledProgram:
    """The program of ``payload`` (:func:`serialize_program`), to be called
    as ``spec.fn`` would be.  Raises on a payload ``torch.export.load``
    cannot read."""
    extra = {_EXTRA: ""}
    with _schema_type_hints_cached():
        ep = torch.export.load(io.BytesIO(payload), extra_files=extra)
    meta = json.loads(extra[_EXTRA])
    return InstalledProgram(
        ep.module(), len(spec.resident),
        {int(i): j for i, j in meta["resident_outputs"].items()},
        spec.inputs)


# ---------------------------------------------------------------------------
# ProgramStore
# ---------------------------------------------------------------------------
_CODE_VERSION_CACHE: Optional[str] = None


def _code_version() -> str:
    """Content hash of the port's own Python source: the fingerprint sees
    only the top-level function's text, not its callees (the model code),
    whose ops the exported graph holds, so any edit to the package must
    invalidate stored programs.  Hashed once per process."""
    global _CODE_VERSION_CACHE
    if _CODE_VERSION_CACHE is None:
        h = hashlib.sha256()
        root = Path(__file__).resolve().parent.parent   # src/repro_torch
        for p in sorted(root.rglob("*.py")):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
        _CODE_VERSION_CACHE = h.hexdigest()[:16]
    return _CODE_VERSION_CACHE


def _device_desc(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def _env_key(device: torch.device) -> Tuple[str, ...]:
    """The environment half of the store key: a program revives only
    under the torch, CUDA, device, kernels and port source that made it."""
    from repro_torch.kernels import _build
    return (torch.__version__, str(torch.version.cuda), _device_desc(device),
            _build._digest()[:16], _code_version())


class ProgramStore:
    """Persistent 'global memory' for exported programs.

    Layout (one entry per (fingerprint, environment) digest)::

        <dir>/<digest>.pt2     the payload (``torch.export.save``)
        <dir>/<digest>.json    {key, fingerprint, env, bytes, time}

    Writes are atomic (tmp + rename) so a crashed writer never corrupts a
    warm-boot path; a payload that cannot be read is a miss (the caller
    runs the Python function and overwrites the entry).

    One store directory may be open in many executors at once: every
    write lands under a unique temp name (pid + per-process sequence) and
    becomes visible only through an atomic ``os.replace``, so a reader
    sees the old or the new complete entry, never a partial; racing
    writers of one digest are last-writer-wins (both payloads hold the
    same program); a reader that loses a race with ``clear()`` reports a
    plain miss; a corrupt shared entry degrades one executor to the
    fallback, whose put heals the entry for everyone after.
    """

    def __init__(self, directory):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.skipped = 0          # programs that could not be exported
        # the counters are updated from a fleet's background boot thread
        # too (repro_torch.core.syscore.preload)
        self._lock = threading.Lock()

    # -- keying -------------------------------------------------------------
    def digest(self, spec: ProgramSpec) -> str:
        h = hashlib.sha256()
        h.update(spec.fingerprint.encode())
        h.update("|".join(self._env_key(spec.device)).encode())
        return h.hexdigest()[:24]

    def _env_key(self, device: torch.device) -> Tuple[str, ...]:
        return _env_key(device)

    # -- read path ----------------------------------------------------------
    def get(self, spec: ProgramSpec) -> Optional[bytes]:
        """The payload on a hit; None on a miss."""
        return self.read(self.digest(spec))

    def read(self, digest: str) -> Optional[bytes]:
        """The payload stored under ``digest`` (:meth:`digest`) on a hit;
        None on a miss.  Reads the file and counts, nothing else: safe on
        a thread beside a serving one."""
        p = self.directory / (digest + ".pt2")
        try:
            payload = p.read_bytes()
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return payload

    def unreadable(self):
        """Count the last hit as a miss: its payload could not be
        loaded."""
        with self._lock:
            self.hits -= 1
            self.misses += 1

    def contains(self, spec: ProgramSpec) -> bool:
        return (self.directory / (self.digest(spec) + ".pt2")).exists()

    # -- write path ---------------------------------------------------------
    _tmp_seq = itertools.count()     # class-wide: unique across same-process
                                     # stores sharing one directory

    def _atomic_write(self, name: str, data: bytes) -> Path:
        """Write ``<dir>/<name>`` atomically: into a unique temp file, then
        ``os.replace`` into place (overwrites a racing writer's entry
        whole, never interleaves with it)."""
        final = self.directory / name
        tmp = self.directory / \
            f".tmp_{name}_{os.getpid()}_{next(self._tmp_seq)}"
        try:
            tmp.write_bytes(data)
            os.replace(tmp, final)
        finally:
            tmp.unlink(missing_ok=True)
        return final

    def put(self, spec: ProgramSpec, payload: bytes) -> Path:
        digest = self.digest(spec)
        final = self._atomic_write(digest + ".pt2", payload)
        meta = {"key": spec.key, "fingerprint": spec.fingerprint,
                "env": self._env_key(spec.device), "bytes": len(payload),
                "time": time.time()}
        self._atomic_write(digest + ".json",
                           json.dumps(meta, indent=1).encode())
        with self._lock:
            self.puts += 1
        return final

    # -- management ---------------------------------------------------------
    def entries(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for meta_path in sorted(self.directory.glob("*.json")):
            try:
                out[meta_path.stem] = json.loads(meta_path.read_text())
            except (OSError, ValueError):
                continue
        return out

    def clear(self):
        for p in self.directory.glob("*.pt2"):
            p.unlink(missing_ok=True)
        for p in self.directory.glob("*.json"):
            p.unlink(missing_ok=True)

    def report(self) -> Dict[str, Any]:
        entries = self.entries()
        return {"dir": str(self.directory), "entries": len(entries),
                "bytes": sum(e.get("bytes", 0) for e in entries.values()),
                "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "skipped": self.skipped}
