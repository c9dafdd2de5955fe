"""Paper Table 1, boot edition, on the port: a cold boot against a warm
boot from a :class:`~repro_torch.core.program_store.ProgramStore` (the
counterpart of ``benchmarks/bench_boot.py``).

A cold boot runs every program from its Python function (on the card:
warm-up and capture) and exports it into the store; a warm boot, in a
fresh process over the same store directory and seed, installs every
program from its export instead (``source == "store"``, ``load_s`` the
``torch.export.load``) and never calls a program function; on the card
it still warms each program up and captures it (``lower_s`` and
``compile_s``), since a CUDA graph cannot be serialized.  Both serve the
same requests, whose token streams must be equal.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.boot --store-dir DIR [--arch qwen3-0.6b]
        [--full] [--device cuda] [--prompt-lens 16,200,57]
        [--arrivals 0,0,0] [--max-new 32] [--layers N]

boots cold over ``DIR`` in this process, then runs itself with ``--warm``
in a fresh one, and prints one JSON line: ``{"cold": {...}, "warm":
{...}, "token_exact": ...}``.  With ``--warm`` it boots warm alone and
prints that boot's JSON line: ``boot_s``, per program ``source``,
``load_s``, ``lower_s``, ``compile_s``, ``export_s`` and
``serialized_bytes``, the store's report, the calls of the program
functions (``python_calls``), the device time of a ``decode`` replay on
the card, the kernel launches of the serving run, the generated tokens
and the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bench.common import device_record, events_ms, sync
from repro_torch.core.program_store import ProgramStore
from repro_torch.engine_config import EngineConfig
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import encdec, transformer

# the model entry points the serving programs call: a warm boot calls none
PROGRAM_ENTRY_POINTS = ((transformer, ("forward", "decode_step",
                                       "prefill_offset", "decode_horizon",
                                       "verify_decode")),
                        (encdec, ("forward", "decode_step")))


class EntryPointCounter:
    """Counts calls of the model entry points the programs run, while
    installed (``with``)."""

    def __init__(self):
        self.calls = 0
        self._saved = []

    def __enter__(self):
        for mod, names in PROGRAM_ENTRY_POINTS:
            for name in names:
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def workload(vocab: int, prompt_lens: Sequence[int]) -> List[np.ndarray]:
    """The requests' prompts: numpy seed 0, as the chip script's serving
    phases draw them."""
    rng = np.random.default_rng(0)
    return [rng.integers(1, vocab, size=p) for p in prompt_lens]


def decode_replay_ms(eng: ServingEngine) -> Optional[float]:
    """Device ms of one replay of the engine's ``decode`` program (CUDA
    events over 20 replays; the caches' positions advance, so call it
    after serving).  None on the CPU."""
    if eng.device.type != "cuda":
        return None
    token = torch.zeros((eng.batch, 1), dtype=torch.int32, device=eng.device)
    decode = eng.programs["decode"]
    return events_ms(lambda: decode(eng.params, eng.caches, token), 20)


def run_boot(arch: str, store_dir, *, full: bool = False,
             device: str = "cuda", batch: int = 4, max_len: int = 512,
             prefill_len: Optional[int] = None, seed: int = 0,
             prompt_lens: Sequence[int] = (16, 200, 57, 120),
             arrivals: Optional[Sequence[float]] = None, max_new: int = 8,
             n_layers: Optional[int] = None
             ) -> Tuple[ServingEngine, Dict[str, object]]:
    """Boot an engine over the store at ``store_dir``, serve the workload
    and return the engine and the boot's record; ``n_layers`` cuts the
    model's depth (``EngineConfig.n_layers``)."""
    config = EngineConfig(reduced=not full, batch=batch, max_len=max_len,
                          prefill_len=prefill_len, clock="step", seed=seed,
                          n_layers=n_layers)
    arrivals = arrivals if arrivals is not None else [0] * len(prompt_lens)
    with EntryPointCounter() as counter:
        t0 = time.perf_counter()
        eng = ServingEngine(arch, config, device=device,
                            store=ProgramStore(store_dir))
        sync(eng.device)
        boot_s = time.perf_counter() - t0
        boot_calls = counter.calls
        reqs = [eng.submit(p, max_new=max_new, arrival_time=a)
                for p, a in zip(workload(eng.cfg.vocab_size, prompt_lens),
                                arrivals)]
        ops.reset_launch_counts()
        stats = eng.run()
        launches, routes = ops.launch_counts(), ops.route_counts()
    fields = ("source", "load_s", "lower_s", "compile_s",
              "serialized_bytes")
    programs = {k: {f: p[f] for f in fields}
                for k, p in eng.syscore.report()["programs"].items()}
    for k, p in programs.items():
        p["export_s"] = eng.programs[k].stats.export_s
    record = {"arch": arch, "full": full, "n_layers": eng.cfg.n_layers,
              "batch": batch,
              "max_len": max_len, "prefill_len": eng.prefill_len,
              "boot_s": boot_s, "programs": programs,
              "store": eng.syscore.store.report(),
              "python_calls": {"boot": boot_calls,
                               "boot_and_serve": counter.calls},
              "decode_p50_ms": stats["decode_p50_ms"],
              "admitted": stats["admitted"],
              "decode_steps": stats["decode_steps"],
              "launches": launches, "launches_by_route": routes,
              "tokens": [r.generated for r in reqs],
              "device": device_record(eng.device)}
    return eng, record


def _ints(text: str) -> List[int]:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store-dir", required=True)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None,
                    help="default: 512 with --full, else 64")
    ap.add_argument("--prefill-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-lens", default="16,200,57,120")
    ap.add_argument("--arrivals", default=None)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first LAYERS layers")
    ap.add_argument("--warm", action="store_true",
                    help="boot warm from the store alone and print it")
    args = ap.parse_args(argv)
    max_len = args.max_len or (512 if args.full else 64)
    prompt_lens = _ints(args.prompt_lens)
    kw = dict(full=args.full, device=args.device, batch=args.batch,
              max_len=max_len, prefill_len=args.prefill_len, seed=args.seed,
              prompt_lens=prompt_lens,
              arrivals=_ints(args.arrivals) if args.arrivals else None,
              max_new=args.max_new, n_layers=args.layers)
    if args.warm:
        eng, record = run_boot(args.arch, args.store_dir, **kw)
        record["decode_replay_device_ms"] = decode_replay_ms(eng)
        print(json.dumps(record), flush=True)
        return 0
    eng, cold = run_boot(args.arch, args.store_dir, **kw)
    cold["decode_replay_device_ms"] = decode_replay_ms(eng)
    del eng
    cmd = [sys.executable, "-m", "repro_torch.bench.boot", "--warm",
           *(a for a in (argv if argv is not None else sys.argv[1:])
             if a != "--warm")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         env=dict(os.environ))
    warm = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps({"cold": cold, "warm": warm,
                      "token_exact": cold["tokens"] == warm["tokens"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
