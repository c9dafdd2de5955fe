"""``HostCallTable.user_call`` in the port numbers user host functions as
the reference's does (``repro/core/hostcall.py``): from 1024 upward,
shared with ``register``, and the number dispatches the function."""
from repro.core.hostcall import HostCallTable as JHostCallTable
from repro_torch.core.hostcall import HostCallTable


def test_user_call_numbers_as_the_reference():
    port, ref = HostCallTable(), JHostCallTable()
    seen = []
    fns = [lambda v: seen.append(("a", v)), lambda v: seen.append(("b", v)),
           lambda v: seen.append(("c", v))]
    got = [port.user_call(fns[0]), port.register(fns[1]),
           port.user_call(fns[2])]
    want = [ref.user_call(fns[0]), ref.register(fns[1]),
            ref.user_call(fns[2])]
    assert got == want == [1024, 1025, 1026]
    for n, v in zip(got, (1.0, 2.0, 3.0)):
        port.dispatch(n, v)
    assert seen == [("a", 1.0), ("b", 2.0), ("c", 3.0)]
