"""hostcall — the numbered host-call dispatch table (paper §3.5, C5).

Port of ``repro/core/hostcall.py``.  The call-number ABI is the same:

    <512       Linux system calls, dispatched directly
    512..1023  runtime-provided utilities
    >=1024     user-registered functions

Engine code dispatches host calls directly (:meth:`HostCallTable.dispatch`).
A program calls the host from inside itself with
:meth:`HostCallTable.hostcall` (no value) or
:meth:`HostCallTable.hostcall_value` (a value that later ops of the same
program read), the reference's io_callback and pure_callback.  On the CPU
(and where no argument is a tensor on the card) such a call dispatches at
once, in program order.  On the card it is a
host function on the current stream (``csrc/hostcall.cu``, through
``cudaLaunchHostFunc``): each device argument is copied to pinned host
staging before it, and a value's pinned buffer is copied back to the device
after it.  Stream capture records the three as nodes of the graph, so a
captured program runs the call once per replay, in order with its kernels.

The host function runs on a CUDA runtime thread and takes the interpreter
lock through a ``ctypes`` callback, so a host thread that waits for the stream
while holding the lock would deadlock: PyTorch's synchronizing calls
(``torch.cuda.synchronize``, ``Event.synchronize``, a replay) release it.
The callback touches no CUDA API, as the runtime requires; an exception in
it cannot reach the stream, so it is recorded in
:attr:`HostCallTable.errors`.  A call's staging and callback live as long
as the graph that recorded it (:func:`capture_sites`); an eager call's are
freed by :meth:`HostCallTable.release`.  ``torch.export`` cannot hold a
host call: under export a call raises :class:`HostCallExportError`, so a
program that makes one is the store's unserializable case.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

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
        self.errors: List[str] = []       # failures inside host functions
        self._eager_sites: list = []      # eager calls' staging on the card
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

    # -- in-graph entry points ----------------------------------------------
    def hostcall(self, number: int, *args):
        """Effectful host call from inside a program (no return value).

        The arguments are tensors or Python numbers; the dispatch receives
        each tensor as a numpy array of its values at this point of the
        program (bf16 and fp16 as float32)."""
        self._call(number, args, None, ())

    def hostcall_value(self, number: int, dtype: torch.dtype, *args,
                       shape: Sequence[int] = ()) -> torch.Tensor:
        """Value-returning host call: a tensor of ``shape`` and ``dtype``
        on the arguments' device holding what the dispatch returned, which
        later ops of the program read."""
        return self._call(number, args, dtype, tuple(shape))

    def _call(self, number, args, dtype, shape):
        if torch.compiler.is_compiling():
            raise HostCallExportError(
                f"hostcall {number}: a host call cannot be exported "
                f"(torch.export); its program stays a Python function")
        if self._table.get(int(number)) is None:
            raise KeyError(f"hostcall {number} not registered")
        card = next((a.device for a in args if isinstance(a, torch.Tensor)
                     and a.device.type == "cuda"), None)
        if card is None:
            res = self.dispatch(number, *(_host_value(a) for a in args))
            if dtype is None:
                return None
            return torch.as_tensor(np.asarray(res), dtype=dtype).reshape(
                shape).clone()
        site = _Site(self, int(number), args, dtype, shape, card)
        sites = _SITE_LISTS[-1] if _SITE_LISTS else self._eager_sites
        sites.append(site)
        if not _SITE_LISTS and len(self._eager_sites) > MAX_EAGER_SITES:
            self.release()
        return site.out

    def release(self):
        """Free the staging of the eager calls made on the card so far
        (after a synchronize, so that every one of them has run).  A
        captured call's staging lives with its graph."""
        if self._eager_sites:
            torch.cuda.synchronize()
            self._eager_sites.clear()
        _free_deferred()


class HostCallExportError(RuntimeError):
    """A host call met ``torch.export``, which cannot hold one."""


# eager calls' staging kept before release() frees it all
MAX_EAGER_SITES = 256

# the site lists of the captures in progress (:func:`capture_sites`)
_SITE_LISTS: List[list] = []
# pinned buffers whose owner died on another thread than the main one (a
# CUDA runtime thread may not call the CUDA API): freed by the next call or
# release() on the main thread
_DEFERRED: List[int] = []


@contextlib.contextmanager
def capture_sites(sites: list):
    """Calls made on the card inside the block (a graph's capture) put
    their staging and callbacks in ``sites``, which the caller keeps as
    long as the graph."""
    _SITE_LISTS.append(sites)
    try:
        yield sites
    finally:
        _SITE_LISTS.pop()


def _host_value(a):
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy().copy()
    return a


def _free_deferred():
    if _DEFERRED and threading.current_thread() is threading.main_thread():
        from repro_torch.kernels import _build
        lib = _build.library()
        while _DEFERRED:
            lib.repro_host_free(_DEFERRED.pop())


class _Site:
    """One host call on the card: pinned staging for its device arguments
    and its value, numpy views of them, and the ctypes callback that the
    host function runs.  Enqueued on the current stream as it is made."""

    def __init__(self, table: HostCallTable, number: int, args, dtype,
                 shape, device: torch.device):
        from repro_torch.kernels import _build
        _free_deferred()
        lib = _build.library()
        self.table, self.number = table, number
        self._ptrs: List[int] = []
        self._keep = []                 # device tensors the copies read
        self._values = []               # numpy views, or Python constants
        dev_ptrs, host_ptrs, sizes = [], [], []
        for a in args:
            if not isinstance(a, torch.Tensor):
                self._values.append(a)
                continue
            t = a.detach()
            if t.dtype in (torch.bfloat16, torch.float16):
                t = t.float()
            t = t.contiguous()
            view, ptr = self._pinned(lib, t.shape, t.dtype)
            self._keep.append(t)
            self._values.append(view)
            dev_ptrs.append(t.data_ptr())
            host_ptrs.append(ptr)
            sizes.append(t.numel() * t.element_size())
        self.out = self._out_view = None
        out_ptr = host_out = None
        out_bytes = 0
        if dtype is not None:
            self.out = torch.empty(shape, dtype=dtype, device=device)
            self._out_view, host_out = self._pinned(lib, shape, dtype)
            out_ptr, out_bytes = self.out.data_ptr(), \
                self.out.numel() * self.out.element_size()
        self._cfn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(self._run)
        n = len(dev_ptrs)
        err = lib.repro_hostcall(
            _build.stream_handle(device.index),
            ctypes.cast(self._cfn, ctypes.c_void_p), None, n,
            (ctypes.c_void_p * max(n, 1))(*dev_ptrs),
            (ctypes.c_void_p * max(n, 1))(*host_ptrs),
            (ctypes.c_longlong * max(n, 1))(*sizes), host_out, out_ptr,
            out_bytes)
        _build.check(err, f"hostcall {number}")

    def _pinned(self, lib, shape, dtype):
        """A numpy view of new pinned host memory for a tensor of ``shape``
        and ``dtype``, and its address."""
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        nbytes = int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize
        ptr = lib.repro_host_alloc(max(nbytes, 1))
        if not ptr:
            raise MemoryError(f"hostcall {self.number}: cannot pin "
                              f"{nbytes} bytes of host staging")
        self._ptrs.append(ptr)
        raw = (ctypes.c_ubyte * max(nbytes, 1)).from_address(ptr)
        view = np.frombuffer(raw, dtype=np_dtype,
                             count=nbytes // np_dtype.itemsize)
        return view.reshape(tuple(shape)), ptr

    def _run(self, _user):
        """The host function (on a CUDA runtime thread, under the
        interpreter lock): dispatch with this replay's argument values;
        write the value."""
        try:
            values = [v.copy() if isinstance(v, np.ndarray) else v
                      for v in self._values]
            res = self.table.dispatch(self.number, *values)
            if self._out_view is not None:
                self._out_view[...] = np.asarray(res,
                                                 self._out_view.dtype)
        except Exception as e:  # nothing above the runtime can catch it
            self.table.errors.append(
                f"hostcall {self.number}: {type(e).__name__}: {e}")

    def __del__(self):
        ptrs, self._ptrs = self._ptrs, []
        if sys.is_finalizing():
            return                      # the process frees its memory
        if threading.current_thread() is not threading.main_thread():
            _DEFERRED.extend(ptrs)
            return
        if ptrs:
            from repro_torch.kernels import _build
            lib = _build.library()
            for p in ptrs:
                lib.repro_host_free(p)


GLOBAL_TABLE = HostCallTable()


def hostcall(number: int, *args):
    GLOBAL_TABLE.hostcall(number, *args)


def register_user_call(fn: Callable) -> int:
    return GLOBAL_TABLE.register(fn)
