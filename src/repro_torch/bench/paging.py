"""The paged KV arena on the port (paper §3.4, data pages): the
counterpart of ``benchmarks/bench_paging.py``.

The reference's workload: 4 x batch requests from
``numpy.random.default_rng(0)`` (prompts of 4 to prefill_len tokens
below 500, 4-8 new tokens) whose KV blocks are at least twice the arena
(half the batch's blocks), served by the paged engine with timeslice
round-robin preemption (3 tokens), then by an unpaged engine on the same
weights.  Asserted, as in the reference: the footprint ratio is at least
2, the arena evicted at least once, and every stream equals the unpaged
engine's.  The record holds the reference's fields (arena hits, loads,
evictions, page faults, swap-outs; the engine's preemptions, swap-ins,
decode steps, occupancy, tok/s) plus the streams and the device.

By default the published config in bf16 on the card (qwen3-0.6b) at the
reference's geometry (batch 4, max_len 64, blocks of 8; ``--smoke``:
batch 2, max_len 32); ``--reduced`` is the reduced config in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.paging [--arch qwen3-0.6b] [--reduced]
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
from repro_torch.engine_config import EngineConfig, PagingConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine


def workload(rng: np.random.Generator, n_req: int, prefill_len: int):
    """The reference's requests: (prompt, max_new) pairs."""
    return [(rng.integers(1, 500, size=int(rng.integers(4, prefill_len + 1))),
             int(rng.integers(4, 9)))
            for _ in range(n_req)]


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False,
        params=None) -> Dict[str, object]:
    batch, max_len, kv_block = (2, 32, 8) if smoke else (4, 64, 8)
    arena_blocks = batch * (max_len // kv_block) // 2   # half the batch fits
    n_req = 4 * batch
    base = EngineConfig(reduced=not full, batch=batch, max_len=max_len,
                        clock="step", seed=0)
    paged = ServingEngine(arch, base.replace(paging=PagingConfig(
        kv_block=kv_block, arena_blocks=arena_blocks, timeslice=3)),
        params=params, device=device)
    work = workload(np.random.default_rng(0), n_req, paged.prefill_len)
    reqs = [paged.submit(p, max_new=m) for p, m in work]
    kv_blocks = sum(paged._blocks_needed(r.prompt_len, r.max_new)
                    for r in reqs)
    ratio = kv_blocks / arena_blocks
    assert ratio >= 2.0, (kv_blocks, arena_blocks)
    # the unpaged oracle: same weights, workload and step clock
    unpaged = ServingEngine(arch, base, params=paged.params, device=device)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = paged.run()
    wall = time.perf_counter() - t0
    assert stats["requests"] == n_req, stats
    arena = paged.pager.report()
    assert arena["evictions"] >= 1, "no arena pressure exercised"
    paged.pager.check_invariants()

    ureqs = [unpaged.submit(p, max_new=m) for p, m in work]
    ustats = unpaged.run()
    token_exact = all(r.generated == u.generated
                      for r, u in zip(reqs, ureqs))
    assert token_exact, "paged engine diverged from the unpaged engine"
    return {
        "bench": "paging", "arch": arch, "full": full,
        "dtype": str(paged.cfg.dtype), "smoke": smoke, "batch": batch,
        "max_len": max_len, "kv_block": kv_block,
        "arena_blocks": arena_blocks,
        "arena_capacity_bytes": arena["capacity_bytes"],
        "workload": {"requests": n_req, "kv_blocks": kv_blocks,
                     "kv_bytes": kv_blocks * arena["block_bytes"],
                     "footprint_ratio": ratio},
        "arena": {k: arena[k] for k in
                  ("hits", "loads", "evictions", "page_faults", "swap_outs",
                   "block_bytes")},
        "engine": {"requests": stats["requests"],
                   "preemptions": stats["preemptions"],
                   "swap_ins": stats["swap_ins"],
                   "page_faults": stats["page_faults"],
                   "swap_outs": stats["swap_outs"],
                   "decode_steps": stats["decode_steps"],
                   "arena_occupancy": stats["arena_occupancy"],
                   "tok_per_s": stats["tok_per_s"], "wall_s": wall},
        "unpaged_tok_per_s": ustats["tok_per_s"],
        "paged_over_unpaged_tok_per_s":
            stats["tok_per_s"] / ustats["tok_per_s"],
        "token_exact": token_exact,
        "launches": ops.launch_counts(),
        "launches_by_route": ops.route_counts(),
        "streams": [r.generated for r in reqs],
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
