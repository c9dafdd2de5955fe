"""The port's host calls on the CPU (``repro_torch.core.hostcall``), case by
case after ``tests/test_core.py:345-408``: a host call inside a program,
a registered user call with a value that the program reads on, the
one-round-trip ``CALL_BATCH``, ``drain_metrics``, a call in the syscall
range, the module-level table, the refusal under ``torch.export``; and
``cold_execute`` (Table 1's cold row) against a re-execute."""
import numpy as np
import pytest
import torch

from repro_torch.core import hostcall
from repro_torch.core.hostcall import (CALL_BATCH, CALL_METRIC,
                                       CALL_STEP_REPORT, HostCallExportError,
                                       HostCallTable)
from repro_torch.core.program_store import ProgramSpec, serialize_program
from repro_torch.core.syscore import Syscore, cold_execute


def test_hostcall_inside_a_program():
    sc = Syscore("cpu")
    hct = sc.hostcalls

    def step(x):
        y = x * 2
        hct.hostcall(CALL_METRIC, 0, y.sum())
        return (y,)

    prog = sc.hot_load(ProgramSpec("step", step, inputs=(torch.ones(4),)))
    (out,) = prog(torch.ones(4))
    torch.testing.assert_close(out, 2 * torch.ones(4))
    assert hct.metrics[0] == [8.0]
    (out,) = prog(torch.full((4,), 3.0))
    assert hct.metrics[0] == [8.0, 24.0]        # in program order


def test_hostcall_user_registration_and_value_return():
    hct = HostCallTable()
    seen = []
    num = hct.register(lambda a: (seen.append(float(a)), np.float32(a * 3))[1])
    assert num >= 1024

    def step(x):
        y = hct.hostcall_value(num, torch.float32, x)
        return y + 1

    out = step(torch.tensor(2.0))
    assert out.dtype == torch.float32 and out.shape == ()
    assert float(out) == 7.0
    assert seen == [2.0]
    pair = hct.register(lambda a: np.stack([a, -a]))
    got = hct.hostcall_value(pair, torch.int64, torch.tensor([5]), shape=(2, 1))
    assert got.tolist() == [[5], [-5]]


def test_hostcall_batch_one_round_trip_many_calls():
    hct = HostCallTable()
    hct.dispatch(CALL_BATCH, [(CALL_METRIC, 2, 1.5),
                              (CALL_METRIC, 3, 0.5),
                              (CALL_METRIC, 2, 2.5),
                              (CALL_STEP_REPORT, 7, 0.01)])
    assert hct.metrics[2] == [1.5, 2.5]
    assert hct.metrics[3] == [0.5]
    assert hct.step_times == [(7, 0.01)]


def test_hostcall_drain_metrics_resets_channels_and_keeps_excluded():
    hct = HostCallTable()
    for code, val in ((1, 10.0), (2, 20.0), (2, 21.0), (4, 99.0), (9, 1.0)):
        hct.dispatch(CALL_METRIC, code, val)
    drained = hct.drain_metrics(keep=(4,))
    assert drained == {1: [10.0], 2: [20.0, 21.0], 9: [1.0]}
    assert hct.metrics[1] == [] and hct.metrics[2] == []
    assert hct.metrics[9] == []
    assert hct.metrics[4] == [99.0]
    hct.dispatch(CALL_METRIC, 2, 30.0)
    assert drained[2] == [20.0, 21.0]


def test_hostcall_syscall_range_write(tmp_path):
    hct = HostCallTable()
    data = torch.arange(10, dtype=torch.uint8)
    with (tmp_path / "out.bin").open("wb") as f:
        def step(x):
            hct.hostcall(1, f.fileno(), x)      # write(2)
            return x
        step(data)
    assert (tmp_path / "out.bin").read_bytes() == bytes(range(10))


def test_unregistered_call_raises_where_it_is_made():
    with pytest.raises(KeyError, match="4321"):
        HostCallTable().hostcall(4321, torch.ones(1))


def test_module_level_table():
    seen = []
    num = hostcall.register_user_call(lambda v: seen.append(int(v)))
    assert num >= 1024
    hostcall.hostcall(num, torch.tensor(9))
    assert seen == [9]
    assert hostcall.GLOBAL_TABLE.dispatch(39) > 0          # getpid


def test_a_host_call_refuses_export():
    hct = HostCallTable()

    def step(x):
        hct.hostcall(CALL_METRIC, 0, x.sum())
        return (x + 1,)

    with pytest.raises(HostCallExportError):
        serialize_program(ProgramSpec("s", step, inputs=(torch.ones(3),)))
    assert hct.metrics == {}            # nothing was dispatched


def test_cold_execute_equals_a_re_execute():
    """Table 1's cold row runs the function from nothing each call; on
    the CPU that is the function itself, equal to the hot-loaded
    program's re-execute and leaving nothing installed."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(
        np.float32))}
    cache = {"n": torch.zeros(())}

    def step(params, cache, x):
        cache["n"].add_(1)
        return cache, torch.tanh(x @ params["w"])

    x = torch.ones((2, 8))
    _, cold = cold_execute(step, params, cache, x)
    sc = Syscore("cpu")
    prog = sc.hot_load(ProgramSpec("step", step, resident=(params, cache),
                                   inputs=(x,)))
    _, warm = prog(params, cache, x)
    assert torch.equal(cold, warm)
    assert float(cache["n"]) == 2.0
    assert list(sc.programs) == ["step"]
