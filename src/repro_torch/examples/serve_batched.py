"""Continuous-batching serving on the persistent executor, on the port:
the counterpart of ``examples/serve_batched.py``.

Boots the engine once (its Syscore hot-loads ``prefill_slot`` and
``decode``; on the card each is captured as a CUDA graph), then serves
mixed-length requests with staggered arrivals: a finished slot is
refilled between decode steps by a re-execution of ``prefill_slot``, so
the batch never drains while work waits.  The programs' stats show the
execution model: a few hot loads, many re-executions.

With ``--store-dir`` the engine attaches a
:class:`~repro_torch.core.program_store.ProgramStore` (the paper's
"program in global memory" tier): the first run exports every program
into it, a second run with the same directory installs them from their
exports (``source == "store"``, ``load_s`` > 0) without running the
program functions.

With ``--paged --arena-frac 0.5`` the KV cache is a paged block arena
holding half the batch's footprint (paper §3.4): requests rotate through
the scarce blocks by timeslice preemption, swapping to host memory and
back, and the streams stay equal to the batch-of-1 reference.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.examples.serve_batched [--arch qwen3-0.6b]
        [--device cuda] [--store-dir DIR] [--paged --arena-frac 0.5]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.engine_config import EngineConfig, PagingConfig
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.PORTED_ARCHS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--store-dir", default=None,
                    help="persistent program store; rerun with the same dir "
                         "for a warm boot from the exports")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache arena (repro_torch.core.paging)")
    ap.add_argument("--arena-frac", type=float, default=0.5,
                    help="arena capacity as a fraction of the full batch's "
                         "KV footprint (paged mode)")
    args = ap.parse_args(argv)

    kv_block, max_len = 8, 64
    paging = None
    if args.paged:
        full = args.batch * max_len // kv_block
        paging = PagingConfig(kv_block=kv_block, timeslice=4,
                              arena_blocks=max(1, int(full * args.arena_frac)))
    eng = ServingEngine(args.arch, EngineConfig(
        reduced=True, batch=args.batch, max_len=max_len, clock="step",
        store_dir=args.store_dir, paging=paging), device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        lo = min(4, args.max_new)
        eng.submit(rng.integers(1, eng.cfg.vocab_size,
                                size=int(rng.integers(3, 10))),
                   max_new=int(rng.integers(lo, args.max_new + 1)),
                   arrival_time=float(i))          # staggered arrivals
    stats = eng.run()
    print("serving stats:", {k: round(v, 3) if isinstance(v, float) else v
                             for k, v in stats.items()})
    for name, prog in eng.programs.items():
        s, source = prog.stats, prog.program.source
        boot = (f"installed from the store in {s.load_s * 1e3:.1f}ms"
                if source == "store" else
                f"hot-loaded ({source}) in {s.load_s * 1e3:.1f}ms")
        print(f"  program {name}: {boot}, re-executed {s.executions}x")
    if eng.syscore.store is not None:
        print("  program store:", eng.syscore.store.report())
    if args.paged:
        rep = eng.pager.report()
        print(f"  paged arena: {rep['arena_blocks']} blocks "
              f"({rep['capacity_bytes']}B), faults={rep['page_faults']} "
              f"evictions={rep['evictions']} hits={rep['hits']}")
    sample = eng.completed[0]
    print(f"  request 0 generated: {sample.generated}")
    ref = eng.reference_generate(sample.prompt, sample.max_new)
    print(f"  batch-of-1 reference matches: {ref == sample.generated}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
