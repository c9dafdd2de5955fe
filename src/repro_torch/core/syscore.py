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
``ValueError``.  There is no program store yet (ROADMAP Queue 1 item 9),
so nothing is serialized.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.hostcall import CALL_METRIC, HostCallTable
from repro_torch.core.uva import UVARegistry
from repro_torch.kernels import matmul, ops

# CALL_METRIC name codes for program-lifecycle telemetry (engine codes 1..3,
# 6 and 7 live in repro_torch.launch.serve)
METRIC_PROGRAM_COMPILE_MS = 4     # hot_load warmed up and captured a program
METRIC_PROGRAM_LOAD_MS = 5        # hot_load installed a CPU program
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


@dataclass(frozen=True)
class ProgramSpec:
    """A hot-loadable program: its key, the function, and the concrete
    arguments a capture needs (the port's counterpart of the reference's
    ``abstract_args``).

    A call is ``fn(*resident, *inputs)``.  ``resident`` holds the trees
    (nested dicts of tensors) every call passes first, in place, such as
    the engine's parameters and caches; ``inputs`` holds one template per
    per-call argument after them: a tensor of the shape, dtype and device
    that argument brings, 0-dim where a call passes a Python number.  The
    templates' values are what the warm-up runs on."""
    key: str
    fn: Callable
    resident: Tuple[Any, ...] = ()
    inputs: Tuple[torch.Tensor, ...] = ()


@dataclass
class ProgramStats:
    lower_s: float = 0.0           # warm-up on the program's stream
    compile_s: float = 0.0         # graph capture and instantiation
    graph_bytes: int = 0           # device memory the capture reserved for
                                   # the graph's own pool
    load_s: float = 0.0            # hot_load in all
    executions: int = 0
    last_exec_s: float = 0.0       # host time of the last call (launches
                                   # and replays are asynchronous; callers
                                   # that read a result back include the
                                   # device time)


def _leaves(tree):
    """A tree's tensor leaves, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _storage(tree) -> Tuple[int, ...]:
    """The data pointers of a tree's tensor leaves, in sorted key order."""
    return tuple(t.data_ptr() for t in _leaves(tree))


@dataclass
class Program:
    key: str
    fn: Callable                   # the eager function, as given
    storage: Tuple[Tuple[int, ...], ...]   # of each resident tree
    n_inputs: int
    source: str = "python"         # "python" (CPU) or "cuda_graph"
    graph: Optional[torch.cuda.CUDAGraph] = None
    inputs: Tuple[torch.Tensor, ...] = ()  # the graph's static inputs
    outputs: Any = None                    # and its static outputs
    scratch: dict = field(default_factory=dict)   # K2's, for the graph
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


def _nonzero(counts: Dict[str, int]) -> Dict[str, int]:
    return {k: v for k, v in counts.items() if v}


class Syscore:
    """Persistent executor: initialize once, hot-load programs, re-execute.

    ``device`` is the UVA registry's device; ``None`` means the card."""

    def __init__(self, device=None):
        self.programs: Dict[str, Program] = {}
        self._t_boot = time.perf_counter()
        self.hostcalls = HostCallTable()
        self.uva = UVARegistry(device)

    def lookup(self, key: str) -> Program:
        try:
            return self.programs[key]
        except KeyError:
            raise UnknownProgramError(key, self.programs) from None

    def handle(self, key: str) -> ProgramHandle:
        """A handle for an already-installed program (raises otherwise)."""
        self.lookup(key)
        return ProgramHandle(self, key)

    def hot_load(self, spec: ProgramSpec) -> ProgramHandle:
        """Install ``spec`` under its key (the registry swap is the last,
        atomic step) and return its handle.  On the card the program is
        warmed up and captured as a CUDA graph first; the warm-up runs
        the function on the resident trees, so what they hold is
        overwritten."""
        t0 = time.perf_counter()
        prog = Program(key=spec.key, fn=spec.fn,
                       storage=tuple(_storage(t) for t in spec.resident),
                       n_inputs=len(spec.inputs))
        tensors = [*spec.inputs,
                   *(t for tree in spec.resident for t in _leaves(tree))]
        card = next((t.device for t in tensors if t.device.type == "cuda"),
                    None)
        if card is not None:
            self._capture(spec, prog, card)
        prog.stats.load_s = time.perf_counter() - t0
        self.programs[spec.key] = prog
        if card is not None:
            self.hostcalls.dispatch(
                CALL_METRIC, METRIC_PROGRAM_COMPILE_MS,
                1e3 * (prog.stats.lower_s + prog.stats.compile_s))
        else:
            self.hostcalls.dispatch(CALL_METRIC, METRIC_PROGRAM_LOAD_MS,
                                    1e3 * prog.stats.load_s)
        return ProgramHandle(self, spec.key)

    @staticmethod
    def _capture(spec: ProgramSpec, prog: Program, device: torch.device):
        """Warm ``spec`` up on a stream of its own, then capture it.

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
        launches nothing); each replay adds them once.  ``outputs`` is
        whatever the function returned, tensors the graph owns: a tuple,
        or a dict of them inside one (the horizon's events)."""
        stream = torch.cuda.Stream(device)
        static = tuple(t.clone() for t in spec.inputs)
        args = (*spec.resident, *static)
        stream.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(stream), \
                    matmul.scratch_table(prog.scratch):
                spec.fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        # the capture empties the allocator's cache as it begins; emptied
        # first, what the capture reserves is the graph's pool alone
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        launches0, routes0 = ops.launch_counts(), ops.route_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream), \
                matmul.scratch_table(prog.scratch):
            outputs = spec.fn(*args)
        t2 = time.perf_counter()
        launches = _nonzero({k: v - launches0[k]
                             for k, v in ops.launch_counts().items()})
        routes = {k: _nonzero({r: v - routes0[k][r] for r, v in by.items()})
                  for k, by in ops.route_counts().items()}
        routes = {k: v for k, v in routes.items() if v}
        ops.add_launch_counts(launches, routes, times=-1)
        prog.source, prog.graph = "cuda_graph", graph
        prog.inputs, prog.outputs = static, outputs
        prog.launches, prog.routes = launches, routes
        prog.stats.lower_s, prog.stats.compile_s = t1 - t0, t2 - t1
        prog.stats.graph_bytes = torch.cuda.memory_reserved(device) \
            - reserved0

    def report(self) -> Dict[str, Any]:
        """Same ``programs`` and ``hostcalls`` schema as the reference;
        nothing is serialized (no program store)."""
        return {
            "uptime_s": time.perf_counter() - self._t_boot,
            "programs": {
                k: {"lower_s": p.stats.lower_s,
                    "compile_s": p.stats.compile_s,
                    "load_s": p.stats.load_s,
                    "executions": p.stats.executions,
                    "serialized_bytes": 0,
                    "source": p.source,
                    "fingerprint": ""}
                for k, p in self.programs.items()},
            "hostcalls": self._hostcall_summary(),
        }

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
