"""Serving throughput on the port: the serving half of the reference's
``benchmarks/bench_pipeline.py:serve_throughput``.

The reference's trace, from ``numpy.random.default_rng(0)``: 32 requests
(12 with ``--smoke``) of 3-11 random prompt tokens and 2-16 new tokens
(2-8), all due at once, through one continuous-batching engine at batch
4 with burst admission (``group_prefill``): the cold-start burst is
admitted by one whole-batch ``prefill`` execution, later refills go
through ``prefill_slot``.  The record holds the reference's fields
(``tok_per_s``, ``decode_p50_ms``, ``ttft_ms``, ``occupancy``,
``refill_admissions``, each program's executions) and, besides, every
generated stream, the kernel launches of the run and the device.

By default the published config in bf16 on the card (qwen3-0.6b at
max_len 512); ``--reduced`` is the reference's own size (the reduced
config in fp32 at max_len 64).  The engine is decoder-only, so
``--arch`` takes every ported arch but seamless-m4t-medium.  The
cross-pod half of the reference's bench reads multi-pod training dry-run
records and waits for ROADMAP Queue 1 items 13 and 14.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.serve [--arch qwen3-0.6b] [--reduced]
        [--device cuda] [--smoke] [--out PATH]

prints one JSON line; ``--out`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from repro_torch.bench.common import device_record, write_out
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry

SERVE_ARCHS = tuple(a for a in registry.PORTED_ARCHS
                    if not registry.get_config(a).is_encdec)


def trace(vocab_size: int, smoke: bool = False):
    """The reference's requests, from ``default_rng(0)``: (prompt,
    max_new) pairs."""
    n_req, max_new = (12, 8) if smoke else (32, 16)
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab_size, size=int(rng.integers(3, 12))),
             int(rng.integers(2, max_new + 1))) for _ in range(n_req)]


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False, params=None,
        keep_engine: bool = False) -> Dict[str, object]:
    """Serve the trace through one engine; ``params`` (on ``device``)
    spares a second draw.  ``keep_engine`` adds the engine under
    ``"_engine"`` (not JSON: the caller pops it)."""
    if arch not in SERVE_ARCHS:
        raise ValueError(f"{arch}: the serving engine is decoder-only; "
                         f"choose one of {SERVE_ARCHS}")
    batch = 4
    max_len = 512 if full else 64
    eng = ServingEngine(arch, EngineConfig(
        reduced=not full, batch=batch, max_len=max_len, seed=0,
        group_prefill=True), params=params, device=device)
    reqs = [eng.submit(p, max_new=m)
            for p, m in trace(eng.cfg.vocab_size, smoke)]
    ops.reset_launch_counts()
    stats = eng.run()
    launches = ops.launch_counts()
    programs = eng.syscore.report()["programs"]
    record = {
        "bench": "serve_throughput", "arch": arch, "full": full,
        "dtype": str(eng.cfg.dtype), "batch": batch, "max_len": max_len,
        "prefill_len": eng.prefill_len, "smoke": smoke,
        "requests": stats["requests"], "tokens": stats["tokens"],
        "tok_per_s": stats["tok_per_s"],
        "decode_p50_ms": stats["decode_p50_ms"],
        "ttft_ms": stats["ttft_ms"], "occupancy": stats["occupancy"],
        "admitted": stats["admitted"],
        "refill_admissions": stats["refill_admissions"],
        "decode_steps": stats["decode_steps"], "wall_s": stats["wall_s"],
        "programs": {k: p["executions"] for k, p in programs.items()},
        "sources": {k: p["source"] for k, p in programs.items()},
        "launches": launches, "launches_by_route": ops.route_counts(),
        "streams": [r.generated for r in reqs],
        "device": device_record(torch.device(device)),
    }
    if keep_engine:
        record["_engine"] = eng
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=SERVE_ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: reduced config, fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke trace: 12 requests")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    record = run(args.arch, full=not args.reduced, device=args.device,
                 smoke=args.smoke)
    write_out(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
