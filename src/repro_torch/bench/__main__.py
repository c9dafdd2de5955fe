"""Every bench of the port in turn (the counterpart of
``benchmarks/run.py``).

Each bench runs in a process of its own (``python -m
repro_torch.bench.<name>``), so one bench's device memory is gone before
the next starts; its JSON line is printed as it comes, with the
process's wall seconds added under ``"seconds"``.  The reference's
benches that need several devices or modules the port does not carry yet
are listed by name with the ROADMAP item they wait for, one JSON line
each.  The exit code is non-zero if any bench failed.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench [--reduced] [--device cuda] [--smoke]
        [--only NAME,...]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List

BENCHES = ("boot", "load_exec", "hostcall", "serve", "placement", "paging",
           "spec", "fused", "prefix", "cluster", "elastic", "autotune",
           "roofline")
# the reference's benches (benchmarks/run.py) the port cannot run yet
WAITING = {"pipeline_cross_pod": "ROADMAP Queue 1 items 13 and 14 "
                                 "(multi-pod training dry-run records)",
           "tp": "ROADMAP Queue 1 item 13 (tensor parallelism)",
           "treeload": "ROADMAP Queue 1 item 13 (the tree loader)"}


def bench_args(name: str, *, reduced: bool, device: str, smoke: bool,
               store_dir: str) -> List[str]:
    """The command-line arguments of one bench."""
    dev = ["--device", device]
    if name == "boot":
        return ["--store-dir", store_dir, *dev] + ([] if reduced
                                                   else ["--full"])
    if name == "hostcall":
        return dev
    if name in ("load_exec", "placement"):
        return dev + (["--reduced"] if reduced else [])
    if name == "roofline":              # counts on meta: no device
        return (["--reduced"] if reduced else []) + \
            (["--smoke"] if smoke else [])
    return dev + (["--reduced"] if reduced else []) + \
        (["--smoke"] if smoke else [])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's sizes (reduced configs, fp32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke workloads")
    ap.add_argument("--only", default=None,
                    help="comma-separated benches to run (default: all)")
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(BENCHES)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown benches {unknown}; choose from {BENCHES}")
    failed = []
    store_dir = tempfile.mkdtemp(prefix="repro_bench_store_")
    try:
        for name in names:
            cmd = [sys.executable, "-m", f"repro_torch.bench.{name}",
                   *bench_args(name, reduced=args.reduced,
                               device=args.device, smoke=args.smoke,
                               store_dir=store_dir)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, stdout=subprocess.PIPE, text=True,
                                 env=dict(os.environ))
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0 or not lines:
                failed.append(name)
                print(json.dumps({"bench": name, "ok": False,
                                  "returncode": res.returncode}), flush=True)
                continue
            record = json.loads(lines[-1])
            record["seconds"] = time.perf_counter() - t0
            print(json.dumps(record), flush=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    for name, why in WAITING.items():
        print(json.dumps({"bench": name, "waits_for": why}), flush=True)
    if failed:
        print(f"benches failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
