"""syscore — the persistent executor (paper §3.3, C2), port of
``repro/core/syscore.py``.

The resident ``Syscore`` holds the hostcall table and a registry of
hot-loaded programs.  In the port a program is a Python callable that
launches the port's kernels eagerly; ``hot_load`` installs it once under
its key and returns a :class:`ProgramHandle`, and calling the handle is the
re-execute path (a registry lookup and a call).  There is no program store
yet (ROADMAP Queue 1 item 9), so nothing is serialized or compiled here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

from repro_torch.core.hostcall import CALL_METRIC, HostCallTable

# CALL_METRIC name codes for program-lifecycle telemetry (engine codes 1..3
# live in repro_torch.launch.serve)
METRIC_PROGRAM_COMPILE_MS = 4     # boot-time build of the programs' kernels
METRIC_PROGRAM_LOAD_MS = 5        # hot_load installed a program


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
    """A hot-loadable program: its key and the callable."""
    key: str
    fn: Callable


@dataclass
class ProgramStats:
    load_s: float = 0.0            # hot-load (install) time
    executions: int = 0
    last_exec_s: float = 0.0       # host time of the last call (launches
                                   # are asynchronous; callers that read a
                                   # result back include the device time)


@dataclass
class Program:
    key: str
    fn: Callable
    stats: ProgramStats = field(default_factory=ProgramStats)


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
        out = prog.fn(*args)
        prog.stats.last_exec_s = time.perf_counter() - t0
        prog.stats.executions += 1
        return out


class Syscore:
    """Persistent executor: initialize once, hot-load programs, re-execute."""

    def __init__(self):
        self.programs: Dict[str, Program] = {}
        self._t_boot = time.perf_counter()
        self.hostcalls = HostCallTable()

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
        atomic step) and return its handle."""
        t0 = time.perf_counter()
        prog = Program(key=spec.key, fn=spec.fn)
        prog.stats.load_s = time.perf_counter() - t0
        self.programs[spec.key] = prog
        self.hostcalls.dispatch(CALL_METRIC, METRIC_PROGRAM_LOAD_MS,
                                1e3 * prog.stats.load_s)
        return ProgramHandle(self, spec.key)

    def report(self) -> Dict[str, Any]:
        """Same ``programs`` and ``hostcalls`` schema as the reference; the
        fields of compilation and serialization stay 0 (no program store)."""
        return {
            "uptime_s": time.perf_counter() - self._t_boot,
            "programs": {
                k: {"lower_s": 0.0,
                    "compile_s": 0.0,
                    "load_s": p.stats.load_s,
                    "executions": p.stats.executions,
                    "serialized_bytes": 0,
                    "source": "python",
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
