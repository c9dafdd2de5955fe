"""Speculative decoding on the port (paper Table 1, applied to decode):
the counterpart of ``benchmarks/bench_spec.py``.

The reference's workload: candidate prompts (8 random tokens from
``numpy.random.default_rng(0)`` and the model's own 96-token
continuation, cut to prefill_len) are probed by replaying the n-gram
proposer against each one's 48-token greedy continuation
(:func:`simulate_spec_steps`: exactness makes the replay predict the
engine's acceptance); copies of the most lookup-predictable prompt are
then served by the step engine and by the speculative engine (k 12,
bigram), after one warm-up request each.  Asserted, as in the
reference: every request finished, and every speculative stream equals
the step engine's.  The reference also asserts a decode speedup of at
least 1.5, a figure set on its own device at reduced size; the port
reports the speedup and asserts no speed.

By default the published config in bf16 on the card (qwen3-0.6b) at the
reference's geometry (batch 2, max_len 256, prefill_len 128; 8 requests
and 24 candidates, ``--smoke`` 4 and 16); ``--reduced`` is the reduced
config in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.spec [--arch qwen3-0.6b] [--reduced]
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
from repro_torch.engine_config import EngineConfig, SpecConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import METRIC_DECODE_MS, ServingEngine
from repro_torch.spec import NGramProposer

BATCH, MAX_LEN, PREFILL_LEN = 2, 256, 128
MAX_NEW, SPEC_K, NGRAM = 48, 12, 2


def simulate_spec_steps(prompt, cont, k: int, ngram: int) -> int:
    """Verify steps a speculative engine would need to emit ``cont``: the
    proposer replayed against the continuation, each step accepting the
    longest matching prefix of its drafts and advancing 1 + accepted."""
    prop = NGramProposer(ngram)
    prop.observe(list(prompt))
    prop.observe(cont[:1])
    i, steps = 1, 0
    while i < len(cont):
        props = prop.propose(k)
        acc = 0
        while acc < len(props) and i + acc < len(cont) \
                and props[acc] == cont[i + acc]:
            acc += 1
        take = min(1 + acc, len(cont) - i)
        prop.observe(cont[i:i + take])
        i += take
        steps += 1
    return max(steps, 1)


def decode_tok_per_s(eng, stats) -> float:
    """Tokens of the decode path over the decode programs' wall time
    (admissions excluded)."""
    dec_s = sum(eng.syscore.hostcalls.metrics[METRIC_DECODE_MS]) / 1e3
    return (stats["tokens"] - stats["requests"]) / max(dec_s, 1e-9)


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", smoke: bool = False,
        params=None) -> Dict[str, object]:
    n_req, n_cand = (4, 16) if smoke else (8, 24)
    config = EngineConfig(reduced=not full, batch=BATCH, max_len=MAX_LEN,
                          prefill_len=PREFILL_LEN, clock="step", seed=0)
    base = ServingEngine(arch, config, params=params, device=device)
    rng = np.random.default_rng(0)
    cands = []
    for _ in range(n_cand):
        seed = rng.integers(1, base.cfg.vocab_size, size=8)
        warm = base.reference_generate(seed, 96)
        prompt = np.concatenate([seed, np.asarray(warm)])[-PREFILL_LEN:]
        cont = base.reference_generate(prompt, MAX_NEW)
        cands.append((simulate_spec_steps(prompt, cont, SPEC_K, NGRAM),
                      prompt))
    cands.sort(key=lambda c: c[0])
    sim_steps = cands[0][0]
    prompts = [cands[0][1]] * n_req
    base.drain_completed()

    spec = ServingEngine(arch, config.replace(
        spec=SpecConfig(k=SPEC_K, ngram=NGRAM)), params=base.params,
        device=device)
    # one warm-up request through each engine, then fresh metric windows
    for eng in (base, spec):
        eng.submit(prompts[0][:8], max_new=4)
        eng.run()
        eng.drain_completed()

    ops.reset_launch_counts()
    base_reqs = [base.submit(p, max_new=MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    base_stats = base.run()
    base_wall = time.perf_counter() - t0
    assert base_stats["requests"] == n_req, base_stats
    base_tps = decode_tok_per_s(base, base_stats)

    spec_reqs = [spec.submit(p, max_new=MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    spec_stats = spec.run()
    spec_wall = time.perf_counter() - t0
    assert spec_stats["requests"] == n_req, spec_stats
    spec_tps = decode_tok_per_s(spec, spec_stats)

    token_exact = all(b.generated == s.generated
                      for b, s in zip(base_reqs, spec_reqs))
    assert token_exact, "speculative engine diverged from the step engine"
    return {
        "bench": "spec", "arch": arch, "full": full,
        "dtype": str(base.cfg.dtype), "smoke": smoke, "batch": BATCH,
        "max_len": MAX_LEN, "prefill_len": PREFILL_LEN, "spec_k": SPEC_K,
        "spec_ngram": NGRAM,
        "workload": {"requests": n_req, "max_new": MAX_NEW,
                     "candidates_probed": n_cand,
                     "simulated_spec_steps": sim_steps,
                     "prompt": prompts[0].tolist()},
        "baseline": {"decode_steps": base_stats["decode_steps"],
                     "decode_tok_per_s": base_tps, "wall_s": base_wall},
        "spec": {"decode_steps": spec_stats["decode_steps"],
                 "verify_steps": spec_stats["spec_steps"],
                 "draft_tokens": spec_stats["draft_tokens"],
                 "accepted_drafts": spec_stats["accepted_drafts"],
                 "accept_rate": spec_stats["accept_rate"],
                 "decode_tok_per_s": spec_tps, "wall_s": spec_wall},
        "speedup": spec_tps / base_tps,
        "token_exact": token_exact,
        "launches": ops.launch_counts(),
        "launches_by_route": ops.route_counts(),
        "streams": [r.generated for r in spec_reqs],
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
