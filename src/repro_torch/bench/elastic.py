"""Elastic cluster serving on the port: the fleet autoscales 1 -> 4 under a
traffic ramp (the counterpart of ``benchmarks/bench_elastic.py``).

The reference's workload and driver: requests of 180-250 random tokens
and 20 new from ``numpy.random.default_rng(0)``, arriving on a fixed
schedule of supervisor passes (a flat phase at 1x, then 2x, ~3x and 4x;
``--smoke`` the shorter schedule), served at batch 4, max_len 320 and
prefill_len 256.  One replica starts; sustained load grows the fleet
replica by replica, each spawn's store loads running on a background
thread while the fleet serves (``ScaleConfig(async_spawn=True)``) and
each attach rebalancing queued requests onto the new replica; past the
schedule, 4x traffic continues (from ``default_rng(1)``) until the third
grow attaches.  A static 4-replica fleet then replays the identical
arrivals.  Asserted, as in the reference: three grows to four running
replicas, each warm (by the card's rule: every program from the store,
no program function called, one store hit per program and no put,
nothing exported; on the card ``compile_s`` is the capture), zero lost
requests on both fleets, and merged streams equal to the static fleet's.
Reported, not asserted: the reference's gate of a ramp p99 TTFT under 2x
the flat phase's, a figure set on its own device (on the card a warm
load takes seconds, not the reference's ~100 ms), and the requests
rebalanced.

Straggler replacement is off by its named switch, as in the reference:
the replicas share one process, so a concurrent load inflates every
replica's supervised tick wall (the interpreter lock).  While a load is
in flight the driver paces its passes at ``BOOT_CADENCE_S``, which hands
the interpreter to the load.

By default the published config in bf16 on the card (qwen3-0.6b);
``--reduced`` is the reduced config in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.elastic [--arch qwen3-0.6b] [--reduced]
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
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bench.cluster import CountingSupervisor, boot_checks
from repro_torch.bench.common import device_record, write_out
from repro_torch.bench.serve import SERVE_ARCHS
from repro_torch.core.program_store import ProgramStore
from repro_torch.engine_config import ClusterConfig, EngineConfig, ScaleConfig
from repro_torch.kernels import ops

# arrival interval in supervisor passes per phase (the reference's):
# service is ~20 passes, so 1x keeps ~1 of the 4 slots busy and 4x ~4
INTERVALS = {"flat": 20, "x2": 10, "x3": 7, "x4": 5}
MAX_NEW = 20
CADENCE_S = 3e-3          # min wall per driver pass (the reference's)
BOOT_CADENCE_S = 25e-3    # min wall per pass while a load is in flight:
                          # the reference's 9 ms is sized for its ~100 ms
                          # boot; a full-width load on the card's host
                          # takes seconds, and the slack hands it the
                          # interpreter
EXTEND_CAP = 3000         # 4x passes past the schedule, at most


def _req(rng):
    """One request: a long prompt (~200 tokens) so TTFT is dominated by
    the prefill program, not scheduling jitter."""
    return rng.integers(1, 500, size=int(rng.integers(180, 251))), MAX_NEW


def schedule(rng, counts):
    """[(pass_idx, prompt, max_new)] over warmup + flat + ramp phases,
    plus the first pass of the flat and ramp eras (TTFT windows)."""
    sched, marks, p = [], {}, 0
    for phase, n in counts:
        interval = INTERVALS.get(phase, INTERVALS["flat"])
        marks.setdefault("ramp" if phase.startswith("x") else phase, p)
        for _ in range(n):
            prompt, max_new = _req(rng)
            sched.append((p, prompt, max_new))
            p += interval
    return sched, marks


def phase_counts(smoke: bool):
    return ([("warmup", 2), ("flat", 12), ("x2", 10), ("x3", 12),
             ("x4", 60)] if smoke else
            [("warmup", 2), ("flat", 20), ("x2", 16), ("x3", 20),
             ("x4", 120)])


def _p99(xs):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))] if xs else None


def drive(sup, sched, marks=None, cadence_s=None, extend=None):
    """Tick ``sup`` one supervisor pass per driver pass, submitting the
    scheduled arrivals at their pass boundaries.

    ``extend`` (elastic cell only): {"pool": iterator, "target": n,
    "cap": passes} — after the schedule is exhausted, keep 4x traffic
    flowing (appending the new arrivals to ``sched`` for the static
    replay) until ``target`` replicas are running.  Returns (rids,
    ttft_marks): the submitted rids and, per mark, the ``sup._ttft_ms``
    offset where that era begins."""
    rids, ttft_marks = [], {}
    i = p = 0
    extended = 0
    next_t = time.perf_counter()
    while True:
        if i >= len(sched):
            if extend is None:
                break
            running = sum(1 for r in sup.replicas if r.state == "running")
            if running >= extend["target"] or extended >= extend["cap"]:
                break
            prompt, max_new = next(extend["pool"])
            sched.append((sched[-1][0] + INTERVALS["x4"], prompt, max_new))
            extended += INTERVALS["x4"]
        if cadence_s is not None:
            lag = next_t - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            next_t = (max(next_t, time.perf_counter()) +
                      (BOOT_CADENCE_S if sup.spawning else cadence_s))
        for name, at in (marks or {}).items():
            if p == at:
                ttft_marks[name] = len(sup._ttft_ms)
        while i < len(sched) and sched[i][0] <= p:
            _, prompt, max_new = sched[i]
            i += 1
            rid = sup.submit(prompt, max_new=max_new)
            assert rid is not None, "admission refused mid-schedule"
            rids.append(rid)
        sup.run(max_ticks=1)
        p += 1
    return rids, ttft_marks


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False, params=None,
        store_dir: Optional[str] = None) -> Dict[str, object]:
    ecfg = EngineConfig(reduced=not full, batch=4, max_len=320,
                        prefill_len=256, clock="step", seed=0,
                        device=device)
    scale = ScaleConfig(min_replicas=1, max_replicas=4,
                        high_watermark=0.3, low_watermark=0.02,
                        sustain_window=3, cooldown=12, async_spawn=True,
                        straggler_detection=False)
    sched, marks = schedule(np.random.default_rng(0), phase_counts(smoke))

    def _pool(rng=np.random.default_rng(1)):
        while True:
            yield _req(rng)

    tmp = None
    if store_dir is None:
        tmp = store_dir = tempfile.mkdtemp(prefix="bench_elastic_store_")
    ops.reset_launch_counts()
    try:
        # -- elastic cell: 1 replica + ScaleConfig, ramped traffic --------
        sup = CountingSupervisor(arch, ClusterConfig(
            engine=ecfg, replicas=1, scale=scale), params=params,
            store=ProgramStore(store_dir))
        n_progs = len(sup.replicas[0].engine.programs)
        hits0, puts0, misses0 = (sup.store.hits, sup.store.puts,
                                 sup.store.misses)
        t0 = time.perf_counter()
        rids, ttft_marks = drive(sup, sched, marks=marks,
                                 cadence_s=CADENCE_S,
                                 extend={"pool": _pool(), "target": 4,
                                         "cap": EXTEND_CAP})
        stats = sup.run()            # drain the tail
        elastic_wall = time.perf_counter() - t0
        flat_ttft = sup._ttft_ms[ttft_marks["flat"]:ttft_marks["ramp"]]
        ramp_ttft = sup._ttft_ms[ttft_marks["ramp"]:]
        grows = [e for e in sup.scale_events if e["action"] == "grow"]
        checks = [boot_checks(b) for b in sup.boots[1:]]
        store_grow = {"hits": sup.store.hits - hits0,
                      "puts": sup.store.puts - puts0,
                      "misses": sup.store.misses - misses0}
        elastic_streams = {r: sup.streams[r] for r in rids}
        rebalanced = sup.rebalanced
        dtype = str(sup.replicas[0].engine.cfg.dtype)
        params = sup.params          # share: greedy streams stay exact
        sup.close()
        del sup
        gc.collect()
        # -- static 4-replica fleet replays the identical schedule --------
        sup4 = CountingSupervisor(arch, ClusterConfig(
            engine=ecfg, replicas=4),
            params=params, store=ProgramStore(store_dir))
        static_boots_calls = [b["python_calls"] for b in sup4.boots]
        rids4, _ = drive(sup4, sched)
        stats4 = sup4.run()
        static_streams = {r: sup4.streams[r] for r in rids4}
        sup4.close()
        del sup4
        gc.collect()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    # -- gates ------------------------------------------------------------
    n_req = len(sched)
    assert stats["completed_all"] and stats4["completed_all"]
    assert sorted(elastic_streams) == rids and len(rids) == n_req, \
        "elastic fleet lost requests"
    assert sorted(static_streams) == rids4 and rids4 == rids, \
        "static fleet lost requests"
    token_exact = elastic_streams == static_streams
    assert token_exact, "streams diverged from the static fleet"
    assert len(grows) == 3 and stats["running_replicas"] == 4, \
        (len(grows), stats["running_replicas"])
    for e, c in zip(grows, checks):
        assert e["warm"] and e["load_s"] > 0 and c["warm"], (e, c)
        assert e["plan"]["new_axes"]["replica"] == \
            e["plan"]["old_axes"]["replica"] + 1, e
    assert store_grow == {"hits": 3 * n_progs, "puts": 0, "misses": 0}, \
        store_grow
    assert static_boots_calls == [0, 0, 0, 0], static_boots_calls
    flat_p99, ramp_p99 = _p99(flat_ttft), _p99(ramp_ttft)
    assert flat_p99 is not None and ramp_p99 is not None
    return {
        "bench": "elastic", "arch": arch, "full": full, "dtype": dtype,
        "smoke": smoke,
        "engine": {"batch": ecfg.batch, "max_len": ecfg.max_len,
                   "prefill_len": ecfg.prefill_len, "clock": "step"},
        "scale": {"min_replicas": 1, "max_replicas": 4,
                  "high_watermark": scale.high_watermark,
                  "low_watermark": scale.low_watermark,
                  "sustain_window": scale.sustain_window,
                  "cooldown": scale.cooldown, "async_spawn": True,
                  "straggler_detection": scale.straggler_detection},
        "requests": n_req,
        "scheduled_requests": sum(n for _, n in phase_counts(smoke)),
        "intervals_passes": INTERVALS,
        "cadence_s": CADENCE_S, "boot_cadence_s": BOOT_CADENCE_S,
        "flat_ttft_p99_ms": flat_p99,
        "ramp_ttft_p99_ms": ramp_p99,
        "ttft_ratio": ramp_p99 / flat_p99,
        "grow_events": [dict({k: e.get(k) for k in
                              ("replica", "pass", "reason", "boot_s",
                               "load_wall_s", "attach_s", "warm",
                               "compile_s", "lower_s", "load_s", "plan")},
                             checks={k: c[k] for k in (
                                 "from_store", "no_program_function_called",
                                 "nothing_exported")})
                        for e, c in zip(grows, checks)],
        "store_during_grows": store_grow,
        "rebalanced": rebalanced,
        "elastic_wall_s": elastic_wall,
        "tok_per_s_wall": sum(len(s) for s in elastic_streams.values())
        / elastic_wall,
        "zero_lost": True,
        "token_exact_vs_static_fleet": token_exact,
        "streams": {str(r): s for r, s in elastic_streams.items()},
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
