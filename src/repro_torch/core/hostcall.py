"""hostcall — the numbered host-call dispatch table (paper §3.5, C5).

Port of ``repro/core/hostcall.py`` without its in-graph entry points: the
port runs eagerly, so engine code dispatches host calls directly.  The
call-number ABI is the same:

    <512       Linux system calls, dispatched directly
    512..1023  runtime-provided utilities
    >=1024     user-registered functions
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np

SYS_RANGE = 512
RUNTIME_RANGE = 1024

CALL_LOG = 512
CALL_METRIC = 513
CALL_CHECKPOINT_REQUEST = 514
CALL_TIME = 515
CALL_STEP_REPORT = 516        # step-time telemetry
CALL_DMALLOC = 517            # reserved: shared-buffer allocation (UVA)
CALL_BATCH = 518              # one round trip carrying many (number, *args)


class HostCallTable:
    """Numbered dispatch table + registration, owned by a Syscore."""

    def __init__(self):
        self._table: Dict[int, Callable] = {}
        self._next_user = 1024
        self.log_lines: list = []
        self.metrics: Dict[int, list] = {}
        self.step_times: list = []
        self.step_stamps: list = []
        self.checkpoint_requests: list = []
        self._register_builtins()

    # -- registration --------------------------------------------------------
    def register(self, fn: Callable, number: Optional[int] = None) -> int:
        if number is None:
            number = self._next_user
            self._next_user += 1
        self._table[number] = fn
        return number

    def _register_builtins(self):
        self._table[1] = lambda fd, data: os.write(
            int(fd), bytes(np.asarray(data, np.uint8)))
        self._table[39] = lambda: os.getpid()
        self._table[CALL_LOG] = self._log
        self._table[CALL_METRIC] = self._metric
        self._table[CALL_TIME] = lambda: time.time()
        self._table[CALL_STEP_REPORT] = self._step_report
        self._table[CALL_CHECKPOINT_REQUEST] = self._ckpt_request
        self._table[CALL_BATCH] = self._batch

    # -- builtin impls ---------------------------------------------------------
    def _log(self, step, value):
        self.log_lines.append((int(step), float(value)))

    def _metric(self, name_code, value):
        self.metrics.setdefault(int(name_code), []).append(float(value))

    def _step_report(self, step, wall_s, t=None):
        self.step_times.append((int(step), float(wall_s)))
        self.step_stamps.append(None if t is None else float(t))

    def _ckpt_request(self, step):
        self.checkpoint_requests.append(int(step))

    def _batch(self, calls):
        """One round trip, many calls: ``calls`` is a sequence of
        ``(number, *args)`` tuples, each dispatched in order."""
        for entry in calls:
            self.dispatch(entry[0], *entry[1:])

    # -- channel maintenance -----------------------------------------------
    def drain_metrics(self, keep=()) -> Dict[int, list]:
        """Return-and-reset every CALL_METRIC channel not in ``keep``."""
        drained: Dict[int, list] = {}
        for code in list(self.metrics):
            if code in keep:
                continue
            drained[code] = self.metrics[code]
            self.metrics[code] = []
        return drained

    # -- dispatch --------------------------------------------------------------
    def dispatch(self, number: int, *args):
        fn = self._table.get(int(number))
        if fn is None:
            raise KeyError(f"hostcall {number} not registered")
        return fn(*args)
