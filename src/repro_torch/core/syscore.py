"""syscore — the persistent executor (paper §3.3, C2), port of
``repro/core/syscore.py``.

The resident ``Syscore`` holds the hostcall table, the UVA buffer registry
(:class:`~repro_torch.core.uva.UVARegistry`, whose host views the paged KV
arena's host tier binds) and a registry of hot-loaded programs.  A program is a Python function over the port's
kernels and the trees it is bound to (the engine's parameters and caches);
``hot_load`` installs it once under its key and returns a
:class:`ProgramHandle`, and calling the handle is the re-execute path.

On the card, ``hot_load`` is the port's form of the reference's
``jax.jit(...).lower(...).compile()``: it runs the function once on a
stream of the program's own (the warm-up, ``lower_s``: every lazy
allocation and one-time kernel attribute happens there), then captures
one run into a ``torch.cuda.CUDAGraph`` with a memory pool of its own
(``compile_s``: capture and instantiation).  A call copies its per-call
inputs into the program's static buffers, replays the graph and returns
the program's static outputs, which the next call overwrites.  A failed
capture raises; nothing falls back to running eagerly.  On the CPU a call
runs the function itself.

Either way a program is bound to the storage of its resident trees: a call
with a tree whose leaves are not those of ``hot_load`` raises
``ValueError``.

Programs in *global memory* (the paper's fast-load tier) are the job of
:class:`~repro_torch.core.program_store.ProgramStore`: with one attached,
``hot_load`` first looks the spec up there and installs the stored
ExportedProgram in place of the Python function (``source == "store"``,
``load_s`` the ``torch.export.load``); the function is then never called,
not by the warm-up nor by the capture, which on the card still happen (a
CUDA graph cannot be serialized).  A miss runs the function as before and
writes its export back; a program that cannot be exported is marked,
counted in ``store.skipped`` and never tried again.

A serving fleet boots a replica while others serve
(:mod:`repro_torch.cluster`).  The store read and ``torch.export.load`` of
that boot are CPU work with no device side: :func:`preload` does them, on
a background thread if the caller likes, and ``Syscore(preloaded=...)``
installs the result.  Everything else a hot load does touches state that
the whole process shares: the sync debug mode of the warm-up, K2's stack
of scratch tables, the stack of host-call site lists, the kernels' launch
counters that a capture takes its launches back off, the allocator's
cache that it empties before reading its pool's size.  So it runs on the
thread that serves, between replays, never beside them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import hostcall as hostcall_lib
from repro_torch.core.hostcall import CALL_METRIC, HostCallTable
from repro_torch.core.program_store import (InstalledProgram, ProgramSpec,
                                            ProgramStore, install_program,
                                            leaves, serialize_program)
from repro_torch.core.uva import UVARegistry
from repro_torch.kernels import matmul, ops

__all__ = ["ProgramSpec", "ProgramStore", "ProgramHandle", "Syscore",
           "UnknownProgramError", "cold_execute", "Preloaded", "preload"]

# CALL_METRIC name codes for program-lifecycle telemetry (engine codes 1..3,
# 6 and 7 live in repro_torch.launch.serve)
METRIC_PROGRAM_COMPILE_MS = 4     # hot_load warmed up and captured a program
METRIC_PROGRAM_LOAD_MS = 5        # hot_load installed a CPU program, or a
                                  # stored one (its torch.export.load)
METRIC_KERNEL_BUILD_MS = 11       # boot-time build (or load) of the kernels


class UnknownProgramError(KeyError):
    """Lookup of a program key that is not installed in this Syscore."""

    def __init__(self, key: str, installed):
        self.key = key
        self.installed = sorted(installed)
        listing = ", ".join(repr(k) for k in self.installed) or "<none>"
        super().__init__(
            f"program {key!r} is not installed in this Syscore; "
            f"installed programs: [{listing}]")

    def __str__(self):
        return self.args[0]


@dataclass
class ProgramStats:
    lower_s: float = 0.0           # warm-up on the program's stream
    compile_s: float = 0.0         # graph capture and instantiation
    graph_bytes: int = 0           # device memory the capture reserved for
                                   # the graph's own pool
    load_s: float = 0.0            # installed from a payload: its
                                   # torch.export.load; else hot_load in all
    export_s: float = 0.0          # torch.export and save of a store put
    serialized_bytes: int = 0      # the payload's bytes
    executions: int = 0
    last_exec_s: float = 0.0       # host time of the last call (launches
                                   # and replays are asynchronous; callers
                                   # that read a result back include the
                                   # device time)


def _storage(tree) -> Tuple[int, ...]:
    """The data pointers of a tree's tensor leaves, in sorted key order."""
    return tuple(t.data_ptr() for t in leaves(tree))


def _card(spec: ProgramSpec) -> Optional[torch.device]:
    """The card a spec's tensors are on, or None (the CPU)."""
    tensors = [*spec.inputs,
               *(t for tree in spec.resident for t in leaves(tree))]
    return next((t.device for t in tensors if t.device.type == "cuda"),
                None)


@dataclass
class Program:
    key: str
    fn: Callable                   # the eager function: the spec's, or the
                                   # installed payload (InstalledProgram)
    storage: Tuple[Tuple[int, ...], ...]   # of each resident tree
    n_inputs: int
    source: str = "python"         # "python" (CPU), "cuda_graph", "store"
                                   # or "serialized" (both captured on the
                                   # card)
    spec: Optional[ProgramSpec] = None     # what an export traces
    fingerprint: str = ""
    payload: Optional[bytes] = None        # the payload it was installed from
    serializable: Optional[bool] = None    # None: no export tried yet
    export_error: str = ""                 # why the export failed
    graph: Optional[torch.cuda.CUDAGraph] = None
    inputs: Tuple[torch.Tensor, ...] = ()  # the graph's static inputs
    outputs: Any = None                    # and its static outputs
    scratch: dict = field(default_factory=dict)   # K2's, for the graph
    host_sites: List[Any] = field(default_factory=list)  # the graph's host
                                                         # calls
    launches: Dict[str, int] = field(default_factory=dict)
    routes: Dict[str, Dict[str, int]] = field(default_factory=dict)
    stats: ProgramStats = field(default_factory=ProgramStats)

    def run(self, args):
        n = len(self.storage)
        if len(args) != n + self.n_inputs:
            raise TypeError(f"program {self.key!r} takes {n} resident trees "
                            f"and {self.n_inputs} inputs, got {len(args)} "
                            f"arguments")
        for i, (tree, want) in enumerate(zip(args, self.storage)):
            if _storage(tree) != want:
                raise ValueError(
                    f"program {self.key!r} is bound to the storage of the "
                    f"trees it was hot-loaded with; resident argument {i} "
                    f"is another tree")
        if self.graph is None:
            return self.fn(*args)
        for buf, value in zip(self.inputs, args[n:]):
            if isinstance(value, torch.Tensor):
                buf.copy_(value, non_blocking=True)
            else:
                buf.fill_(value)
        self.graph.replay()
        # a replay launches every kernel the capture recorded once
        ops.add_launch_counts(self.launches, self.routes)
        return self.outputs


class ProgramHandle:
    """Callable façade over one installed program; resolves through the
    registry on every call, so an evicted key fails with a clear error."""

    __slots__ = ("_syscore", "key")

    def __init__(self, syscore: "Syscore", key: str):
        self._syscore = syscore
        self.key = key

    @property
    def program(self) -> Program:
        return self._syscore.lookup(self.key)

    @property
    def stats(self) -> ProgramStats:
        return self.program.stats

    def __call__(self, *args):
        prog = self._syscore.lookup(self.key)
        t0 = time.perf_counter()
        out = prog.run(args)
        prog.stats.last_exec_s = time.perf_counter() - t0
        prog.stats.executions += 1
        return out

    def serialize(self) -> bytes:
        return self._syscore.serialize(self.key)

    def evict(self):
        self._syscore.evict(self.key)


@dataclass
class Preloaded:
    """A stored program read and loaded, not yet installed: its payload,
    the loaded callable and the seconds the load took."""
    payload: bytes
    fn: InstalledProgram
    load_s: float


def _load(payload: bytes, spec: ProgramSpec) -> Preloaded:
    t0 = time.perf_counter()
    fn = install_program(payload, spec)
    return Preloaded(payload, fn, time.perf_counter() - t0)


def preload(store: ProgramStore, specs: List[Tuple[ProgramSpec, str]]
            ) -> Dict[str, Preloaded]:
    """Read and load the stored payloads of ``specs``, given as (spec,
    ``store.digest(spec)``) pairs that the caller computed, by
    fingerprint.  File reads and ``torch.export.load`` only: no device
    work and none of the process-wide state a hot load touches, so it may
    run on a thread beside a serving one.  A miss, or a payload that
    cannot be loaded (counted as a miss), is left out: ``hot_load`` then
    takes its usual path for that spec."""
    out = {}
    for spec, digest in specs:
        payload = store.read(digest)
        if payload is None:
            continue
        try:
            out[spec.fingerprint] = _load(payload, spec)
        except Exception:
            store.unreadable()
    return out


def _nonzero(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: v for k, v in counts.items() if v}


def _warm_up(fn: Callable, args, stream, scratch: dict, device):
    """Run ``fn(*args)`` once on ``stream`` with PyTorch's sync debug mode
    at "error", so an op that would wait for the host fails there by name,
    and K2's split products taking their scratch from ``scratch``."""
    stream.wait_stream(torch.cuda.current_stream(device))
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(stream), matmul.scratch_table(scratch):
            fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize(device)


class Syscore:
    """Persistent executor: initialize once, hot-load programs, re-execute.

    ``device`` is the UVA registry's device; ``None`` means the card.
    ``store`` attaches the global-memory tier: hot loads first install
    from it, and programs run from their Python function are exported
    back into it.  ``preloaded``: programs of that store already loaded
    (:func:`preload`), by fingerprint; a hot load of a matching spec
    installs one in place of a store read."""

    def __init__(self, device=None, store: Optional[ProgramStore] = None,
                 preloaded: Optional[Dict[str, Preloaded]] = None):
        self.programs: Dict[str, Program] = {}
        self._t_boot = time.perf_counter()
        self.hostcalls = HostCallTable()
        self.uva = UVARegistry(device)
        self.store = store
        self.preloaded = dict(preloaded or {})

    def lookup(self, key: str) -> Program:
        try:
            return self.programs[key]
        except KeyError:
            raise UnknownProgramError(key, self.programs) from None

    def handle(self, key: str) -> ProgramHandle:
        """A handle for an already-installed program (raises otherwise)."""
        self.lookup(key)
        return ProgramHandle(self, key)

    # -- program lifecycle --------------------------------------------------
    def hot_load(self, spec: ProgramSpec) -> ProgramHandle:
        """Install ``spec`` under its key (the registry swap is the last,
        atomic step) and return its handle.

        With an attached store, a stored payload for the same fingerprint
        and environment is installed in place of ``spec.fn``; on a miss
        the function is installed and its export written back.  On the
        card the program is then warmed up and captured as a CUDA graph;
        the warm-up runs on the resident trees, so what they hold is
        overwritten."""
        t0 = time.perf_counter()
        prog = (self._load_from_store(spec) if self.store is not None
                else None)
        if prog is None:
            prog = self._program(spec, spec.fn, "python")
        card = _card(spec)
        if card is not None:
            self._capture(spec, prog, card)
        if prog.payload is None:
            prog.stats.load_s = time.perf_counter() - t0
        self.programs[spec.key] = prog
        if card is not None:
            self.hostcalls.dispatch(
                CALL_METRIC, METRIC_PROGRAM_COMPILE_MS,
                1e3 * (prog.stats.lower_s + prog.stats.compile_s))
        if card is None or prog.payload is not None:
            self.hostcalls.dispatch(CALL_METRIC, METRIC_PROGRAM_LOAD_MS,
                                    1e3 * prog.stats.load_s)
        if self.store is not None and prog.payload is None:
            self._store_program(prog)
        return ProgramHandle(self, spec.key)

    @staticmethod
    def _program(spec: ProgramSpec, fn: Callable, source: str) -> Program:
        return Program(key=spec.key, fn=fn,
                       storage=tuple(_storage(t) for t in spec.resident),
                       n_inputs=len(spec.inputs), source=source, spec=spec,
                       fingerprint=spec.fingerprint)

    def _install(self, spec: ProgramSpec, loaded: Preloaded,
                 source: str) -> Program:
        """A program of a loaded payload, bound to ``spec``."""
        loaded.fn.templates = spec.inputs
        prog = self._program(spec, loaded.fn, source)
        prog.stats.load_s = loaded.load_s
        prog.payload = loaded.payload
        prog.serializable = True
        prog.stats.serialized_bytes = len(loaded.payload)
        return prog

    def _load_from_store(self, spec: ProgramSpec) -> Optional[Program]:
        loaded = self.preloaded.pop(spec.fingerprint, None)
        if loaded is None:
            payload = self.store.get(spec)
            if payload is None:
                return None
            try:
                loaded = _load(payload, spec)
            except Exception:
                # a payload torch.export.load cannot read (a torn or
                # corrupt entry, a skew the environment key missed): a
                # miss, and the function runs instead
                self.store.unreadable()
                return None
        return self._install(spec, loaded, "store")

    @staticmethod
    def _payload(prog: Program) -> bytes:
        """The program's payload, exported on first use (raises where the
        program cannot be exported)."""
        if prog.payload is None:
            t0 = time.perf_counter()
            prog.payload = serialize_program(prog.spec)
            prog.stats.export_s = time.perf_counter() - t0
        prog.stats.serialized_bytes = len(prog.payload)
        return prog.payload

    def _store_program(self, prog: Program,
                       store: Optional[ProgramStore] = None) -> bool:
        """Export a program into global memory.  A program that cannot be
        exported (an in-graph host call, an op that reads a device value
        on the host) is marked, counted and skipped, never fatal, and
        never tried again."""
        store = store if store is not None else self.store
        if prog.serializable is False:
            return False
        if prog.host_sites:
            # its capture recorded host calls, which torch.export cannot
            # hold: known without tracing the program (a full-width train
            # step's trace takes tens of seconds to reach its report)
            prog.serializable = False
            prog.export_error = (
                f"HostCallExportError: the captured program makes "
                f"{len(prog.host_sites)} in-graph host call(s), which "
                f"torch.export cannot hold")
            store.skipped += 1
            return False
        try:
            payload = self._payload(prog)
        except Exception as e:
            prog.serializable = False
            prog.export_error = f"{type(e).__name__}: {e}"
            store.skipped += 1
            return False
        store.put(prog.spec, payload)
        prog.serializable = True
        return True

    def install_serialized(self, key: str, payload: bytes,
                           spec: ProgramSpec) -> ProgramHandle:
        """Hot-load a serialized program (a program 'in global memory')
        under ``key``, bound to ``spec``'s resident trees and input
        templates; ``spec.fn`` is not called.  The load's cost scales with
        the program, not the weights; on the card the program is then
        warmed up and captured."""
        prog = self._install(spec, _load(payload, spec), "serialized")
        prog.key = key
        card = _card(spec)
        if card is not None:
            self._capture(spec, prog, card)
        self.hostcalls.dispatch(CALL_METRIC, METRIC_PROGRAM_LOAD_MS,
                                1e3 * prog.stats.load_s)
        self.programs[key] = prog
        return ProgramHandle(self, key)

    def serialize(self, key: str) -> bytes:
        """The installed program ``key`` as a payload for global memory
        (raises where it cannot be exported)."""
        return self._payload(self.lookup(key))

    def persist(self, store: Optional[ProgramStore] = None) -> int:
        """Export every installed program not yet in ``store`` (default:
        the attached store); returns how many were newly written.
        Programs that cannot be exported are skipped."""
        store = store if store is not None else self.store
        if store is None:
            return 0
        written = 0
        for prog in self.programs.values():
            if store.contains(prog.spec):
                continue
            if self._store_program(prog, store):
                written += 1
        return written

    def evict(self, key: str):
        self.lookup(key)
        del self.programs[key]

    @staticmethod
    def _capture(spec: ProgramSpec, prog: Program, device: torch.device):
        """Warm ``prog.fn`` up on a stream of its own, then capture it.

        The warm-up runs with PyTorch's sync debug mode at "error", so an
        op that would wait for the host fails there by name.  K2's split
        products take their scratch from a table the program keeps, made
        at the warm-up's shapes, so the graph's pointers stay valid as long
        as the program does.  One scratch serves every product of the
        program, those of all H steps of a horizon or k+1 of a verify
        included: the capture records one stream, so the graph runs its
        products one after another, and each product's last block resets
        the arrival counters for the next.  The launches the capture
        records (a multi-step program records every step's) are kept on
        the program and taken back off the kernels' counters (a capture
        launches nothing); each replay adds them once.  So are the host
        calls it records (their staging and callbacks live as long as the
        graph).  ``outputs`` is whatever the function returned, tensors
        the graph owns: a tuple, or a dict of them inside one (the
        horizon's events)."""
        stream = torch.cuda.Stream(device)
        static = tuple(t.clone() for t in spec.inputs)
        args = (*spec.resident, *static)
        t0 = time.perf_counter()
        _warm_up(prog.fn, args, stream, prog.scratch, device)
        t1 = time.perf_counter()
        # the capture empties the allocator's cache as it begins; emptied
        # first, what the capture reserves is the graph's pool alone
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        launches0, routes0 = ops.launch_counts(), ops.route_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream), \
                matmul.scratch_table(prog.scratch), \
                hostcall_lib.capture_sites(prog.host_sites):
            outputs = prog.fn(*args)
        t2 = time.perf_counter()
        launches = _nonzero({k: v - launches0[k]
                             for k, v in ops.launch_counts().items()})
        routes = {k: _nonzero({r: v - routes0[k][r] for r, v in by.items()})
                  for k, by in ops.route_counts().items()}
        routes = {k: v for k, v in routes.items() if v}
        ops.add_launch_counts(launches, routes, times=-1)
        if prog.source == "python":
            prog.source = "cuda_graph"
        prog.graph = graph
        prog.inputs, prog.outputs = static, outputs
        prog.launches, prog.routes = launches, routes
        prog.stats.lower_s, prog.stats.compile_s = t1 - t0, t2 - t1
        prog.stats.graph_bytes = torch.cuda.memory_reserved(device) \
            - reserved0

    # -- introspection -------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """The reference's ``programs``, ``hostcalls`` and (with a store
        attached) ``store`` schema."""
        rep = {
            "uptime_s": time.perf_counter() - self._t_boot,
            "programs": {
                k: {"lower_s": p.stats.lower_s,
                    "compile_s": p.stats.compile_s,
                    "load_s": p.stats.load_s,
                    "executions": p.stats.executions,
                    "serialized_bytes": p.stats.serialized_bytes,
                    "source": p.source,
                    "fingerprint": p.fingerprint[:12]}
                for k, p in self.programs.items()},
            "hostcalls": self._hostcall_summary(),
        }
        if self.store is not None:
            rep["store"] = self.store.report()
        return rep

    def _hostcall_summary(self) -> Dict[str, Any]:
        metrics = {
            code: {"count": len(vals),
                   "mean": sum(vals) / len(vals),
                   "last": vals[-1]}
            for code, vals in self.hostcalls.metrics.items() if vals}
        stamps = [t for t in self.hostcalls.step_stamps if t is not None]
        return {"metrics": metrics,
                "step_reports": len(self.hostcalls.step_times),
                "step_stamps": len(stamps),
                "step_span_s": (stamps[-1] - stamps[0]) if len(stamps) > 1
                               else 0.0,
                "log_lines": len(self.hostcalls.log_lines)}


def cold_execute(fn: Callable, *args):
    """The eSDK row of Table 1: load and run ``fn(*args)`` from nothing on
    every call.

    The reference's counterpart traces and compiles a fresh ``jax.jit``
    wrapper each time, so nothing is cached between calls.  In the port
    the program that the card executes is the CUDA graph that ``hot_load``
    captures once; so here every call pays what a hot load pays and then
    runs it once: a warm-up (the eager run, with its one-time allocations,
    in sync debug mode "error"), a capture and instantiation into a new
    graph, one replay and a synchronize, after which the graph is dropped.
    The kernel library stays loaded, as the reference's XLA runtime does.
    On the CPU it runs ``fn``.  Returns the replay's outputs."""
    card = next((t.device for tree in args for t in leaves(tree)
                 if isinstance(t, torch.Tensor) and t.device.type == "cuda"),
                None)
    if card is None:
        return fn(*args)
    stream = torch.cuda.Stream(card)
    scratch, sites = {}, []
    _warm_up(fn, args, stream, scratch, card)
    graph = torch.cuda.CUDAGraph()
    # the capture counts the launches that the replay below makes
    with torch.cuda.graph(graph, stream=stream), \
            matmul.scratch_table(scratch), \
            hostcall_lib.capture_sites(sites):
        outputs = fn(*args)
    graph.replay()
    torch.cuda.synchronize(card)
    del graph
    return outputs
