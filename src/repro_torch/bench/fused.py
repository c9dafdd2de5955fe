"""Fused decode horizons on the port (paper §3.3 applied to the decode
loop): the counterpart of ``benchmarks/bench_fused.py``.

The reference's workload: ``batch`` prompts of 8 random tokens from
``numpy.random.default_rng(0)``, 96 new tokens each (48 with
``--smoke``), served at horizons H of 1, 4 and 16 on shared weights, one
warm-up request first; each engine serves the batch 5 times (3) and
keeps its best decode tok/s.  Asserted, as in the reference: every
repeat's streams equal the first of its horizon, every horizon's streams
equal H 1's, and at H 16 the decode path dispatches at most one program
per 8 tokens.  The reference also asserts a decode speedup of at least
1.5 at H 16 (rebuilding engines up to twice to reach it), a figure set
on its own device at reduced size; the port reports the speedups,
asserts no speed and rebuilds nothing.

By default the published config in bf16 on the card (qwen3-0.6b) at the
reference's geometry (batch 2, max_len 128, prefill_len 16);
``--reduced`` is the reduced config in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.fused [--arch qwen3-0.6b] [--reduced]
        [--device cuda] [--smoke] [--out PATH]

prints one JSON line; ``--out`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.bench.common import device_record, write_out
from repro_torch.bench.serve import SERVE_ARCHS
from repro_torch.engine_config import EngineConfig, HorizonConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import METRIC_DECODE_MS, ServingEngine
from repro_torch.models import registry

HORIZONS = (1, 4, 16)
BATCH, MAX_LEN, PREFILL_LEN = 2, 128, 16


def decode_tok_per_s(eng, stats) -> float:
    """Tokens of the decode path over the decode programs' wall time
    (admissions excluded)."""
    dec_s = sum(eng.syscore.hostcalls.metrics[METRIC_DECODE_MS]) / 1e3
    return stats["decode_tokens"] / max(dec_s, 1e-9)


def measure(arch: str, h: int, params, streams, *, full: bool, device: str,
            max_new: int, repeats: int):
    """Boot one engine at horizon ``h`` and return its params and its
    best repeat; every repeat's streams must equal the first measurement
    of this horizon (``streams``)."""
    eng = ServingEngine(arch, EngineConfig(
        reduced=not full, batch=BATCH, max_len=MAX_LEN,
        prefill_len=PREFILL_LEN, clock="step", seed=0,
        horizon=HorizonConfig(length=h) if h > 1 else None),
        params=params, device=device)
    rng = np.random.default_rng(0)            # the same prompts at every H
    prompts = [rng.integers(1, eng.cfg.vocab_size, size=8)
               for _ in range(BATCH)]
    eng.submit(prompts[0][:4], max_new=4)     # warm the decode path
    eng.run()
    eng.drain_completed()
    best_tps, best_wall, stats = 0.0, float("inf"), None
    launches0, routes0 = ops.launch_counts(), ops.route_counts()
    for _ in range(repeats):
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        t0 = time.perf_counter()
        rep_stats = eng.run()
        wall = time.perf_counter() - t0
        assert rep_stats["requests"] == BATCH, rep_stats
        rep_streams = [r.generated for r in reqs]
        assert streams.setdefault(h, rep_streams) == rep_streams
        tps = decode_tok_per_s(eng, rep_stats)
        eng.drain_completed()
        if tps > best_tps:
            best_tps, best_wall, stats = tps, wall, rep_stats
    launches = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    routes = {k: {r: v - routes0[k][r] for r, v in by.items()}
              for k, by in ops.route_counts().items()}
    return eng.params, {
        "launches": launches, "launches_by_route": routes,
        "decode_tok_per_s": best_tps,
        "dispatches": stats["decode_steps"],
        "decode_tokens": stats["decode_tokens"],
        "dispatches_per_token": stats["dispatches_per_token"],
        "horizon_steps": stats.get("horizon_steps", 0),
        "repeats": repeats, "wall_s": best_wall,
    }


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False,
        params=None) -> Dict[str, object]:
    max_new = 48 if smoke else 96
    repeats = 3 if smoke else 5
    results, streams = {}, {}
    for h in HORIZONS:
        params, results[h] = measure(arch, h, params, streams, full=full,
                                     device=device, max_new=max_new,
                                     repeats=repeats)
    token_exact = all(streams[h] == streams[1] for h in HORIZONS)
    assert token_exact, "a fused horizon diverged from the step engine"
    dpt16 = results[16]["dispatches_per_token"]
    assert dpt16 <= 1 / 8, (dpt16, results[16])
    base = results[1]["decode_tok_per_s"]
    return {
        "bench": "fused", "arch": arch, "full": full, "smoke": smoke,
        "dtype": registry.get_config(arch, reduced=not full).dtype,
        "batch": BATCH,
        "max_len": MAX_LEN, "prefill_len": PREFILL_LEN,
        "workload": {"requests": BATCH, "max_new": max_new},
        "horizons": {str(h): results[h] for h in HORIZONS},
        "speedup_h16": results[16]["decode_tok_per_s"] / base,
        "speedup_h4": results[4]["decode_tok_per_s"] / base,
        "dispatches_per_token_h16": dpt16,
        "token_exact": token_exact,
        "launches": {k: sum(results[h]["launches"][k] for h in HORIZONS)
                     for k in ops.KERNELS},
        "launches_by_route": {
            k: {r: sum(results[h]["launches_by_route"][k][r]
                       for h in HORIZONS) for r in by}
            for k, by in results[1]["launches_by_route"].items()},
        "streams": streams[1],
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
