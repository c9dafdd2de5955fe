"""Paper §3.5 on the port: the host-call round trip (the counterpart of
``benchmarks/bench_hostcall.py``; the paper measured 41 us on Epiphany).

Rows:

- ``hostcall_noop_roundtrip``: the median time of a replay of a small
  captured program (``x + 1`` over 64 floats, then the sum as the argument
  of a host call to a registered no-op) minus that of the same program
  without the call: what one in-graph host call costs the program (on
  the card, a D2H copy, a graph host node and the return of the stream);
- ``hostcall_value_roundtrip``: the same for a value-returning call whose
  result a later op of the program reads (an H2D copy more);
- ``uva_host_write_256KB`` and ``uva_write_plus_h2d_256KB``: a host write
  of 64 Ki floats into a :class:`~repro_torch.core.uva.UVARegistry`
  buffer, and that write followed by the copy to the device.

Each program runs through a :class:`~repro_torch.core.syscore.Syscore`:
on the card captured as a CUDA graph, timed on the host clock around a
replay and a synchronize; on the CPU it runs the Python function.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.hostcall [--device cuda]

prints one JSON line: the rows (microseconds) and the device.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from repro_torch.bench.common import device_record, median_s
from repro_torch.core.program_store import ProgramSpec
from repro_torch.core.syscore import Syscore


def run(device: str = "cuda", reps: int = 200) -> Dict[str, object]:
    dev = torch.device(device)
    sc = Syscore(dev)
    hct = sc.hostcalls
    noop = hct.register(lambda v: None)
    ret = hct.register(lambda v: np.float32(v))

    def without_call(x):
        return (x + 1,)

    def with_call(x):
        y = x + 1
        hct.hostcall(noop, y.sum())
        return (y,)

    def with_value(x):
        v = hct.hostcall_value(ret, torch.float32, x.sum())
        return (x + v,)

    x = torch.ones(64, device=dev)
    handles = {fn.__name__: sc.hot_load(ProgramSpec(fn.__name__, fn,
                                                    inputs=(x,)))
               for fn in (without_call, with_call, with_value)}
    t = {name: median_s(lambda h=h: h(x), dev, reps, warmup=5)
         for name, h in handles.items()}
    rows = [{"row": "hostcall_noop_roundtrip",
             "us": 1e6 * (t["with_call"] - t["without_call"]),
             "program_us": 1e6 * t["with_call"],
             "program_without_call_us": 1e6 * t["without_call"],
             "paper_us": 41.0},
            {"row": "hostcall_value_roundtrip",
             "us": 1e6 * (t["with_value"] - t["without_call"]),
             "program_us": 1e6 * t["with_value"]}]
    uva = sc.uva
    uva.alloc("buf", (1 << 16,), torch.float32)
    data = np.arange(1 << 16, dtype=np.float32)
    rows.append({"row": "uva_host_write_256KB",
                 "us": 1e6 * median_s(lambda: uva.write("buf", data), dev,
                                      reps // 10 or 1)})
    # a write dirties the host view, so to_device copies for real
    rows.append({"row": "uva_write_plus_h2d_256KB",
                 "us": 1e6 * median_s(lambda: (uva.write("buf", data),
                                               uva.to_device("buf")), dev,
                                      reps // 10 or 1)})
    if hct.errors:
        raise RuntimeError(f"host calls failed: {hct.errors[:4]}")
    return {"bench": "hostcall", "reps": reps, "rows": rows,
            "device": device_record(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
