"""Cluster serving on the port: fleet widths 1, 2 and 4 with one
kill-and-recover each (the counterpart of ``benchmarks/bench_cluster.py``).

The reference's workload: requests of 4-9 random tokens and 3-5 new from
``numpy.random.default_rng(0)`` (12 at batch 4 and max_len 64; 6 at batch
2 and max_len 32 with ``--smoke``), served by N replicas behind one router
and one shared :class:`~repro_torch.core.program_store.ProgramStore`, with
replica 0 killed at engine step 3 and rebooted from the store (the
reference kills at step 5 at the full size, which its fleet of 4 never
reaches: :func:`geometry`).  Asserted, as in the reference: one kill and one recovery a
cell, zero lost requests, every stream equal across fleet widths; and a
warm recovery.  On the card a warm install still warms each program up
and captures it (``compile_s`` is the capture), so a recovery is warm
when every program of the rebooted engine came from the store
(``source == "store"``), the reboot called no program function, the
store counted one hit per program and wrote nothing, and no program was
exported (``export_s == 0``).  The reference also asserts its cold boot's
compile time over a reboot's load time above 1, a ratio set on its own
device; the port reports the cold boot's seconds over the mean reboot's
(``warm_recovery_speedup``) and asserts no speed.

By default the published config in bf16 on the card (qwen3-0.6b);
``--reduced`` is the reduced config in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.cluster [--arch qwen3-0.6b] [--reduced]
        [--device cuda] [--smoke] [--out PATH]

prints one JSON line; ``--out`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import gc
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bench.boot import EntryPointCounter
from repro_torch.bench.common import device_record, write_out
from repro_torch.bench.serve import SERVE_ARCHS
from repro_torch.cluster import Supervisor
from repro_torch.core.program_store import ProgramStore
from repro_torch.engine_config import ClusterConfig, EngineConfig
from repro_torch.kernels import ops
from repro_torch.runtime.fault import FaultInjector

FLEET = (1, 2, 4)


def workload(n_req: int, rng) -> List[tuple]:
    """The reference's requests: (prompt, max_new) pairs."""
    return [(rng.integers(1, 500, size=int(rng.integers(4, 10))),
             int(m)) for m in rng.integers(3, 6, size=n_req)]


def geometry(smoke: bool):
    """(batch, max_len, requests, kill step): the reference's, but for the
    full size's kill step.  The reference kills at step 5 there, which
    replica 0 never reaches in the fleet of 4 (3 requests of 3-5 tokens,
    done in 4 steps), so its own full-size run fails its one-kill
    assertion; the port kills at step 3, the smoke size's, at both
    sizes."""
    return (2, 32, 6, 3) if smoke else (4, 64, 12, 3)


class CountingSupervisor(Supervisor):
    """A :class:`Supervisor` that keeps, per engine boot, the engine and,
    for a boot over a store that already holds programs (one that should
    be warm), the calls of the model entry points the programs run: a warm
    boot calls none.  A boot over an empty store runs the functions and
    exports them, and is not counted (``python_calls`` None)."""

    def __init__(self, *a, **k):
        self.boots: List[Dict[str, object]] = []
        super().__init__(*a, **k)

    def _boot_engine(self, idx, preloaded=None):
        if self.store is None or not self.store.entries():
            eng = super()._boot_engine(idx, preloaded)
            calls = None
        else:
            with EntryPointCounter() as counter:
                eng = super()._boot_engine(idx, preloaded)
            calls = counter.calls
        self.boots.append({"replica": idx, "python_calls": calls,
                           "engine": eng})
        return eng


def boot_checks(boot: Dict[str, object]) -> Dict[str, object]:
    """The card's warm rule for one boot (an entry of
    :attr:`CountingSupervisor.boots`), but for the store's counters, which
    the caller checks over its window: every program from the store, no
    program function called, nothing exported (``warm``); with the
    boot's load, warm-up and capture seconds."""
    eng = boot["engine"]
    progs = eng.syscore.report()["programs"]
    checks = {
        "from_store": bool(progs) and all(p["source"] == "store"
                                          for p in progs.values()),
        "no_program_function_called": boot["python_calls"] == 0,
        "nothing_exported": all(h.stats.export_s == 0
                                for h in eng.programs.values()),
    }
    return dict(checks, warm=all(checks.values()), replica=boot["replica"],
                load_s=sum(p["load_s"] for p in progs.values()),
                lower_s=sum(p["lower_s"] for p in progs.values()),
                capture_s=sum(p["compile_s"] for p in progs.values()))


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False, params=None,
        store_dir: Optional[str] = None) -> Dict[str, object]:
    batch, max_len, n_req, kill_step = geometry(smoke)
    ecfg = EngineConfig(reduced=not full, batch=batch, max_len=max_len,
                        clock="step", seed=0, device=device)
    work = workload(n_req, np.random.default_rng(0))
    tmp = None
    if store_dir is None:
        tmp = store_dir = tempfile.mkdtemp(prefix="bench_cluster_store_")
    cells, cold_boot_s = [], None
    ops.reset_launch_counts()
    try:
        for n in FLEET:
            inj = FaultInjector(fail_at_steps=[kill_step])
            t0 = time.perf_counter()
            sup = CountingSupervisor(
                arch, ClusterConfig(engine=ecfg, replicas=n), params=params,
                store=ProgramStore(store_dir), fault_hooks={0: inj.check})
            boot_s = time.perf_counter() - t0
            if cold_boot_s is None:      # the first cell exported the
                cold_boot_s = boot_s     # programs; it shares its params
                params = sup.params
            dtype = str(sup.replicas[0].engine.cfg.dtype)
            hits0, puts0 = sup.store.hits, sup.store.puts
            rids = [sup.submit(p, max_new=m) for p, m in work]
            assert all(r is not None for r in rids), "admission refused"
            t0 = time.perf_counter()
            stats = sup.run()
            wall_s = time.perf_counter() - t0
            assert inj.fired == [kill_step], inj.fired
            assert stats["kills"] == 1 and len(stats["recoveries"]) == 1
            assert stats["requests"] == n_req and \
                sorted(sup.streams) == rids, \
                (stats["requests"], sorted(sup.streams))
            rec = stats["recoveries"][0]
            warm = boot_checks(sup.boots[-1])
            store = (sup.store.hits - hits0, sup.store.puts - puts0)
            assert warm["warm"] and rec["warm"] and \
                store == (len(sup.boots[-1]["engine"].programs), 0), \
                (warm, rec, store)
            cells.append({
                "replicas": n,
                "boot_s": boot_s,
                "requests": stats["requests"],
                "tokens": stats["tokens"],
                "wall_s": wall_s,
                "tok_per_s": stats["tok_per_s"],
                "agg_decode_tok_per_s": stats["agg_decode_tok_per_s"],
                "ttft_p99_ms": stats["ttft_p99_ms"],
                "kills": stats["kills"],
                "recovery": dict(
                    {k: rec.get(k) for k in
                     ("replica", "downtime_s", "reboot_s", "warm",
                      "compile_s", "lower_s", "load_s", "replayed")},
                    checks=warm),
                "boots_python_calls": [b["python_calls"]
                                       for b in sup.boots],
                "store": sup.store.report(),
                "streams": {str(r): sup.streams[r] for r in rids},
            })
            sup.close()
            del sup
            gc.collect()                 # the engines' graph pools
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    base = cells[0]["streams"]
    token_exact = all(c["streams"] == base for c in cells[1:])
    assert token_exact, "streams diverged across fleet widths"
    reboots = [c["recovery"]["reboot_s"] for c in cells]
    return {
        "bench": "cluster", "arch": arch, "full": full,
        "dtype": dtype, "smoke": smoke,
        "engine": {"batch": batch, "max_len": max_len, "clock": "step"},
        "requests": n_req, "kill_step": kill_step,
        "cells": [{k: v for k, v in c.items() if k != "streams"}
                  for c in cells],
        "token_exact_across_n": token_exact, "zero_lost": True,
        "cold_boot_s": cold_boot_s,
        "warm_recovery_speedup": cold_boot_s / (sum(reboots) / len(reboots)),
        "streams": base,
        "launches": ops.launch_counts(),
        "launches_by_route": ops.route_counts(),
        "device": device_record(torch.device(device)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=SERVE_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    write_out(run(args.arch, full=not args.reduced, device=args.device,
                  smoke=args.smoke), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
