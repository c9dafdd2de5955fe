"""Fault tolerance: restart-on-failure, straggler detection (port of
``repro/runtime/fault.py``).

At 1000+ nodes, node loss and stragglers are routine.  The contract here:

  * every step is deterministic given (checkpoint step, data seed) —
    the data stream replays exactly after restore;
  * step-time telemetry flows into a StragglerMonitor; sustained
    stragglers trigger the runtime policy (in the serving fleet of
    :mod:`repro_torch.cluster`, replacement of the slow replica).

``run_with_restarts`` is the generic restart loop (the training stack that
calls it in the reference is ROADMAP Queue 1 item 14); a FaultInjector
stands in for real device loss in tests and on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Raise SimulatedFailure at the given global steps (once each)."""
    fail_at_steps: List[int] = field(default_factory=list)
    fired: List[int] = field(default_factory=list)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.append(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerMonitor:
    """Rolling per-step wall-time stats; flags outliers.

    threshold: a step is a straggler observation if it exceeds
    ``threshold x`` the rolling median; ``patience`` consecutive observations
    escalate to action (e.g. exclude the pod and re-mesh)."""
    window: int = 32
    threshold: float = 1.5
    patience: int = 3
    times: List[float] = field(default_factory=list)
    flags: int = 0
    escalations: int = 0

    def observe(self, wall_s: float) -> bool:
        self.times.append(wall_s)
        hist = self.times[-self.window:]
        if len(hist) < 5:
            return False
        med = sorted(hist)[len(hist) // 2]
        if wall_s > self.threshold * med:
            self.flags += 1
            if self.flags >= self.patience:
                self.escalations += 1
                self.flags = 0
                return True
        else:
            self.flags = 0
        return False

    def reset_window(self):
        """Forget the rolling step-time window (and any partial flag run)
        but keep the cumulative ``escalations`` count.  Called when the
        monitored engine is replaced: a fresh boot's step times must not
        be judged against the dead engine's median."""
        self.times.clear()
        self.flags = 0

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"median_s": 0.0, "p99_s": 0.0, "escalations": 0}
        s = sorted(self.times)
        return {"median_s": s[len(s) // 2],
                "p99_s": s[min(len(s) - 1, int(0.99 * len(s)))],
                "escalations": self.escalations}


@dataclass(frozen=True)
class RestartPolicy:
    """Serving-side restart policy for a supervised replica.

    A crashed replica may be rebooted at most ``max_restarts`` times over
    its lifetime; the n-th reboot (n >= 1) waits
    ``backoff_s * backoff_factor**(n-1)`` seconds first, so a replica that
    crash-loops backs off exponentially instead of hammering the boot
    path.  ``backoff_s = 0`` disables the delay entirely (tests and
    deterministic benchmarks).  Past the limit the supervisor stops
    rebooting and re-routes the replica's unfinished requests instead
    (repro_torch.cluster.supervisor)."""
    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0

    def allows(self, n_restart: int) -> bool:
        """May restart attempt ``n_restart`` (1-based) proceed?"""
        return n_restart <= self.max_restarts

    def delay_s(self, n_restart: int) -> float:
        """Back-off delay before restart attempt ``n_restart`` (1-based)."""
        if self.backoff_s <= 0:
            return 0.0
        return self.backoff_s * self.backoff_factor ** (n_restart - 1)


def run_with_restarts(run_fn: Callable[[int], int], *,
                      resume_step_fn: Callable[[], int],
                      max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], None]]
                      = None) -> Dict[str, object]:
    """Supervise ``run_fn(start_step) -> final_step`` with restart-on-failure.

    ``resume_step_fn`` re-reads the latest durable checkpoint step, so every
    restart resumes from persisted state, not in-memory state."""
    restarts = 0
    t0 = time.perf_counter()
    while True:
        start = resume_step_fn()
        try:
            final = run_fn(start)
            return {"final_step": final, "restarts": restarts,
                    "wall_s": time.perf_counter() - t0}
        except SimulatedFailure as e:
            restarts += 1
            if on_restart:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={max_restarts}") from e
