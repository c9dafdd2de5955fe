"""Cross-request prefix sharing on the port: the counterpart of
``benchmarks/bench_prefix.py``.

The reference's workload: one popular prompt of 257 tokens (129 with
``--smoke``), n x 8 + 1 so that its whole head matches and a 1-token
suffix remains, from ``numpy.random.default_rng(0)`` after an untimed
warm-up prompt served twice; the first request prefills and publishes
its blocks, 4 more map them read-only and run only the suffix through
the ``prefill_offset`` program (the warm path).  Asserted, as in the
reference: 5 warm admissions, the tokens reused, every block of the head
matched by at least two requests, every warm stream equal to the cold
one, and the arena's invariants.  The reference also asserts the warm
TTFT under 10% of the cold one (50% with ``--smoke``), a figure set on
its own device at reduced size; the port reports the ratio and asserts
no speed.

By default the published config in bf16 on the card (qwen3-0.6b) at the
reference's geometry (batch 2, blocks of 8, max_len 320, prefill_len
264; ``--smoke``: 160 and 136); ``--reduced`` is the reduced config in
fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.prefix [--arch qwen3-0.6b] [--reduced]
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
from repro_torch.bench.serve import SERVE_ARCHS
from repro_torch.engine_config import EngineConfig, PagingConfig, PrefixConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine

N_WARM = 4                    # warm repeats of the popular prompt
KV_BLOCK = 8


def geometry(smoke: bool):
    """(max_len, prompt_len, prefill_len) of the reference."""
    max_len, prompt_len = (160, 129) if smoke else (320, 257)
    return max_len, prompt_len, prompt_len + 7


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False,
        params=None) -> Dict[str, object]:
    max_len, prompt_len, prefill_len = geometry(smoke)
    eng = ServingEngine(arch, EngineConfig(
        reduced=not full, batch=2, max_len=max_len, prefill_len=prefill_len,
        clock="wall", seed=0, paging=PagingConfig(kv_block=KV_BLOCK),
        prefix=PrefixConfig(max_suffix=1)), params=params, device=device)
    if not eng._prefix_tier1:
        raise ValueError(f"{arch} has no warm (skip-prefill) path")
    rng = np.random.default_rng(0)
    # untimed warm-up: first executions on a throwaway prefix
    warmup = rng.integers(1, 500, size=prompt_len).astype(np.int32)
    for p in (warmup, warmup.copy()):
        eng.submit(p, max_new=2)
        eng.run()

    def serve_one(prompt):
        req = eng.submit(prompt, max_new=4)
        eng.run()
        assert req.done and req.ttft_s is not None
        return req

    base = rng.integers(1, 500, size=prompt_len).astype(np.int32)
    ops.reset_launch_counts()
    cold = serve_one(base)                   # prefills and publishes the head
    warm = [serve_one(base.copy()) for _ in range(N_WARM)]

    shared_blocks = (prompt_len - 1) // KV_BLOCK
    assert eng.warm_admissions == 1 + N_WARM, eng.warm_admissions
    assert eng.prefix_tokens_reused >= \
        (1 + N_WARM) * shared_blocks * KV_BLOCK, eng.prefix_tokens_reused
    popular = [sb for sb in eng.pager._shared.values() if sb.hits >= 2]
    assert len(popular) >= shared_blocks, (len(popular), shared_blocks)
    token_exact = all(w.generated == cold.generated for w in warm)
    assert token_exact, "a warm-prefix stream diverged from the cold one"
    eng.pager.check_invariants()

    warm_ttfts = [w.ttft_s for w in warm]
    rep = eng.pager.report()["prefix"]
    return {
        "bench": "prefix", "arch": arch, "full": full,
        "dtype": str(eng.cfg.dtype), "smoke": smoke, "batch": 2,
        "max_len": max_len, "prompt_len": prompt_len,
        "prefill_len": prefill_len, "kv_block": KV_BLOCK, "max_suffix": 1,
        "shared_blocks": shared_blocks, "warm_requests": N_WARM,
        "ttft": {"cold_ms": cold.ttft_s * 1e3,
                 "warm_ms": [t * 1e3 for t in warm_ttfts],
                 "warm_min_ms": min(warm_ttfts) * 1e3,
                 "warm_mean_ms": float(np.mean(warm_ttfts)) * 1e3,
                 "warm_over_cold": min(warm_ttfts) / cold.ttft_s},
        "prefix": {k: rep[k] for k in
                   ("trie_blocks", "resident_shared", "prefix_hits",
                    "published_blocks", "shared_faults",
                    "shared_evictions")},
        "store": rep["store"],
        "engine": {"warm_admissions": eng.warm_admissions,
                   "prefix_admissions": eng.prefix_admissions,
                   "prefix_tokens_reused": eng.prefix_tokens_reused},
        "token_exact": token_exact,
        "launches": ops.launch_counts(),
        "launches_by_route": ops.route_counts(),
        "streams": [cold.generated] + [w.generated for w in warm],
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
