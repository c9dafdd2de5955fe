"""Paper Table 1 on the port: program load and execute paths (the
counterpart of ``benchmarks/bench_load_exec.py``).

The four rows, on one program: the train program (``--program train``,
``steps.make_train_program`` bound to the train state, its inputs one
batch), as the reference times its training step, or the serving
engine's ``decode`` step (``steps.make_serve_step``, the default) bound to
its parameters and caches.  At full width by default: qwen3-0.6b in bf16,
the train program at 4 x 1,024 tokens, decode at batch 4 and max_len 512.
The train program reports its steps from the host (no in-graph host
call), so that the serialized row can try ``torch.export`` on it; where
the export fails, that row reports the error in place of a time.

=============================  ==========================================
Table 1 row                    here
=============================  ==========================================
eSDK serial loader             ``cold_execute``: warm-up, capture and
                               instantiation of a new CUDA graph, one
                               replay and a synchronize, every call
                               (median of 3)
COPRTHR-2 AOT hot load         ``Syscore.hot_load``: warm-up and capture,
                               once
hot load serialized            ``Syscore.serialize`` (``torch.export``),
                               then ``install_serialized``: the
                               ``torch.export.load`` and, on the card,
                               the warm-up and capture of the loaded
                               program; with the payload's bytes
re-execute                     a call of the handle (a graph replay) and
                               a synchronize (median of 20), and the
                               cold / re-execute ratio
=============================  ==========================================

The Fig. 2 tree-loader rows need several devices and wait for the tree
loader (ROADMAP Queue 1 item 13).

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.load_exec [--arch qwen3-0.6b] [--reduced]
        [--device cuda] [--program decode|train]

prints one JSON line: the rows (each in microseconds) and the device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from repro_torch import steps
from repro_torch.bench.common import device_record, events_ms, median_s, sync
from repro_torch.core.program_store import ProgramSpec, leaves
from repro_torch.core.syscore import Syscore, cold_execute
from repro_torch.models import registry, transformer
from repro_torch.optim import AdamWConfig


def decode_spec(cfg, params, caches, batch: int, device) -> ProgramSpec:
    token = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    return ProgramSpec("decode", steps.make_serve_step(cfg),
                       resident=(params, caches), inputs=(token,),
                       context=repr(cfg))


def train_spec(cfg, state, batch: int, seq: int, device) -> ProgramSpec:
    """The train program at ``batch`` x ``seq`` tokens, bound to
    ``state``, with the default AdamW config."""
    opt = AdamWConfig()
    return steps.train_program_spec(
        cfg, opt, state, steps.batch_templates(cfg, batch, seq, device))


def run(arch: str = "qwen3-0.6b", *, full: bool = True,
        device: str = "cuda", batch: int = 4, max_len: int = 512,
        seed: int = 0, params=None, cold_reps: int = 3,
        reexec_reps: int = 20, program: str = "decode",
        seq: Optional[int] = None) -> Dict[str, object]:
    """Table 1's four rows for ``arch``'s ``program`` ("decode" or
    "train"; ``seq`` the train program's tokens a row, default 1,024 at
    full width and 64 reduced); ``params`` (on ``device``) spares a
    second draw."""
    dev = torch.device(device)
    cfg = registry.get_config(arch, reduced=not full)
    if params is None:
        params = transformer.init_params(cfg, seed, device=dev)
    if program == "train":
        seq = seq or (1024 if full else 64)
        resident = (steps.init_train_state(cfg, params=params),)
        spec = train_spec(cfg, resident[0], batch, seq, dev)
        geometry = {"batch": batch, "seq": seq}
    elif program == "decode":
        resident = (params, transformer.init_cache(cfg, batch, max_len,
                                                   device=dev))
        spec = decode_spec(cfg, *resident, batch, dev)
        geometry = {"batch": batch, "max_len": max_len}
    else:
        raise ValueError(f"program {program!r}: decode or train")
    args = (*resident, *spec.inputs)
    rows: List[Dict[str, object]] = []

    cold = median_s(lambda: cold_execute(spec.fn, *args), dev, cold_reps)
    rows.append({"row": "cold", "us": 1e6 * cold,
                 "what": "cold_execute: warm-up + capture + instantiate + "
                         "replay + sync, every call (median)"})

    sc = Syscore(dev)
    t0 = time.perf_counter()
    handle = sc.hot_load(spec)
    sync(dev)
    hot = time.perf_counter() - t0
    rows.append({"row": "aot_hot_load", "us": 1e6 * hot,
                 "lower_s": handle.stats.lower_s,
                 "compile_s": handle.stats.compile_s,
                 "what": "hot_load: warm-up + capture, once"})

    t0 = time.perf_counter()
    loaded = None
    try:
        payload = sc.serialize(spec.key)
    except Exception as e:
        rows.append({"row": "hot_load_serialized", "us": None,
                     "export_error": f"{type(e).__name__}: {e}",
                     "what": "torch.export of the program failed: no "
                             "payload to load"})
    else:
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = sc.install_serialized(spec.key + "_serialized", payload,
                                       spec)
        sync(dev)
        install = time.perf_counter() - t0
        rows.append({"row": "hot_load_serialized", "us": 1e6 * install,
                     "payload_bytes": len(payload),
                     "load_s": loaded.stats.load_s,
                     "lower_s": loaded.stats.lower_s,
                     "compile_s": loaded.stats.compile_s,
                     "export_s": export_s,
                     "what": "install_serialized: torch.export.load, then "
                             "warm-up + capture on the card"})

    reexec = median_s(lambda: handle(*args), dev, reexec_reps)
    device_ms: Optional[float] = None
    if dev.type == "cuda":
        device_ms = events_ms(lambda: handle(*args), reexec_reps)
    same = (None if loaded is None or program != "decode"
            else _same_outputs(handle, loaded, *args))
    rows.append({"row": "reexecute", "us": 1e6 * reexec,
                 "device_ms": device_ms,
                 "cold_over_reexecute": cold / reexec,
                 "what": "a handle call (graph replay) + sync (median)"})
    return {"bench": "load_exec", "arch": arch, "full": full,
            "program": program, **geometry,
            "dtype": str(cfg.dtype), "rows": rows,
            "serialized_equals_hot_load": same,
            "device": device_record(dev)}


def _copy_tree(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _same_outputs(a, b, params, caches, token) -> bool:
    """Whether programs ``a`` and ``b`` give bit-equal outputs (the next
    tokens and logits) and caches from the same cache state."""
    before = _clone_tree(caches)
    out_a = [t.clone() for t in a(params, caches, token)[1:]]
    after_a = _clone_tree(caches)
    _copy_tree(caches, before)
    out_b = b(params, caches, token)[1:]
    same = all(torch.equal(x, y) for x, y in zip(out_a, out_b))
    return same and all(torch.equal(x, y) for x, y in
                        zip(leaves(after_a), leaves(caches)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", default="decode",
                    choices=("decode", "train"))
    args = ap.parse_args(argv)
    out = run(args.arch, full=not args.reduced, device=args.device,
              max_len=512 if not args.reduced else 64, program=args.program)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
