"""Paper Table 2 on the port: resident bytes and time per placement
layout (the counterpart of ``benchmarks/bench_placement.py``).

The Epiphany table places the Cannon MMM code in core-local memory, in
global memory, or pages it through dynamic calls.  Here, as in the
reference, the placed program is an MoE layer's expert weights, one page
a leaf (each expert's w1, w3 and w2):

=====================  ==================================================
layout                 here
=====================  ==================================================
A usrcore              every expert resident on the device
B usrmem               experts in host memory, copied to the device at
                       each call (``PlacedTree.get``)
C dynamic              experts in host memory, paged with LRU into a
                       device arena of a third of their bytes
                       (``core.dynamic_calls.DynamicCallTable``)
=====================  ==================================================

A pass runs the reference's 24-call skewed routing order (4 hot experts
take most calls), drawn with the weights and the token rows from
``numpy.random.default_rng(0)`` as the reference draws them, one K3 call
(``ops.moe_ffn`` at E 1) per routed expert on the same c token rows.
Rows: each layout's resident bytes, time a pass (a warm pass, then the
mean of 3, each ended by a synchronize) and time relative to A, K3's
launches a pass; then the arena's hits, loads and evictions over two
passes of a fresh layout C (``table2_dc_hit_rate``).  Gate: the three
layouts' outputs are bit-equal, and layout A's agree with K3's plain
version (``moe_dispatch.moe_ffn_ref``) on the same inputs at K3's
tolerance (``TOL``).  On the card the record adds one K3 call on layout
A's weights (CUDA events) against its byte bound.

By default one qwen3-moe-30b-a3b layer's 128 experts at d 2048, f 768 in
bf16 (9.44 MB an expert, 1.21 GB in all), c 32; ``--reduced`` is the
reference's size: 16 experts at d 64, f 256 in fp32.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.placement [--reduced] [--device cuda]
        [--out PATH]

prints one JSON line; ``--out`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.bench.common import (bound_ms, device_record, events_ms,
                                      sync, write_out)
from repro_torch.core.placement import (DYNAMIC, USRCORE, USRMEM,
                                        PlacementPlan, apply_plan, footprint)
from repro_torch.kernels import ops
from repro_torch.kernels.moe_dispatch import moe_ffn_ref, route
from repro_torch.models import registry

LAYOUTS = {"A_usrcore_resident": USRCORE, "B_usrmem_streamed": USRMEM,
           "C_dynamic_paged": DYNAMIC}
PASSES = 3
CALLS = 24
# K3's tolerances (tests/test_kernels.py:189 fp32, :202 bf16): |kernel -
# plain| <= TOL * (1 + |plain|)
TOL = {torch.float32: 3e-4, torch.bfloat16: 5e-2}


def sizes(full: bool) -> Tuple[int, int, int, int, torch.dtype]:
    """(experts, d, f, c, dtype): one qwen3-moe-30b-a3b layer in bf16, or
    the reference's reduced experts in fp32."""
    if not full:
        return 16, 64, 256, 32, torch.float32
    cfg = registry.get_config("qwen3-moe-30b-a3b")
    return cfg.n_experts, cfg.d_model, cfg.d_ff, 32, torch.bfloat16


def workload(e: int, d: int, f: int, c: int):
    """The reference's draws, in its order from ``default_rng(0)``: the
    expert tree (fp32 numpy), the (c, d) token rows and the routing
    order."""
    rng = np.random.default_rng(0)
    mk = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    tree = {f"expert{i}": {"w1": mk(d, f), "w3": mk(d, f), "w2": mk(f, d)}
            for i in range(e)}
    x = (rng.standard_normal((c, d)) * 0.1).astype(np.float32)
    order = [int(v) % 4 if rng.random() < 0.8 else int(v) % e
             for v in rng.integers(0, 1 << 30, size=CALLS)]
    return tree, x, order


def _invoke(placed, order: List[int], x: torch.Tensor) -> List[torch.Tensor]:
    """One routed pass: a K3 call per expert of ``order`` (the jump
    table)."""
    outs = []
    for i in order:
        w = [placed.get(f"expert{i}/{k}") for k in ("w1", "w3", "w2")]
        outs.append(ops.moe_ffn(x[None], *(t[None] for t in w))[0])
    return outs


def run(*, full: bool = True, device: str = "cuda",
        keep_outputs: bool = False) -> Dict[str, object]:
    """Table 2's rows; ``keep_outputs`` adds the first pass's outputs
    (CPU tensors) and the workload under ``"_outputs"``/``"_workload"``
    (not JSON: the tests pop them)."""
    dev = torch.device(device)
    e, d, f, c, dtype = sizes(full)
    tree_np, x_np, order = workload(e, d, f, c)
    tree = {k: {n: torch.from_numpy(a).to(dtype) for n, a in v.items()}
            for k, v in tree_np.items()}
    total = footprint(tree)
    x = torch.from_numpy(x_np).to(dev, dtype)
    arena = total // 3

    ops.reset_launch_counts()
    rows, outputs, base = [], {}, None
    for name, klass in LAYOUTS.items():
        placed = apply_plan(tree, PlacementPlan(default=klass),
                            arena_bytes=arena, device=dev)
        outputs[name] = [o.cpu() for o in _invoke(placed, order, x)]
        sync(dev)
        launches0 = ops.moe_ffn.launches
        t0 = time.perf_counter()
        for _ in range(PASSES):
            _invoke(placed, order, x)
            sync(dev)
        dt = (time.perf_counter() - t0) / PASSES
        resident = placed.report()["bytes"][USRCORE]
        if klass == DYNAMIC:
            resident = placed.dc_table.resident_bytes
        base = base or dt
        rows.append({"row": f"table2_{name}", "us_per_pass": 1e6 * dt,
                     "rel_time": dt / base, "resident_bytes": resident,
                     "total_bytes": total,
                     "launches_per_pass":
                         (ops.moe_ffn.launches - launches0) / PASSES})
        del placed
    # the arena's loads and hits over two passes of a fresh layout C
    placed = apply_plan(tree, PlacementPlan(default=DYNAMIC),
                        arena_bytes=arena, device=dev)
    _invoke(placed, order, x)
    _invoke(placed, order, x)
    sync(dev)
    rep = placed.dc_table.report()
    loads = sum(p["loads"] for p in rep["pages"].values())
    hits = sum(p["hits"] for p in rep["pages"].values())
    rows.append({"row": "table2_dc_hit_rate",
                 "value": hits / max(hits + loads, 1), "hits": hits,
                 "loads": loads, "evictions": rep["evictions"]})
    del placed
    first = outputs["A_usrcore_resident"]
    equal = {name: all(torch.equal(a, b) for a, b in zip(first, outs))
             for name, outs in outputs.items()}
    if not all(equal.values()):
        raise AssertionError(f"the layouts' outputs differ: {equal}")
    plain_err = _against_plain(tree, x, order, first, dev, dtype)
    record = {"bench": "placement", "full": full, "experts": e, "d": d,
              "f": f, "c": c, "dtype": str(dtype).replace("torch.", ""),
              "order": order, "total_bytes": total,
              "expert_bytes": total // e, "arena_bytes": arena,
              "rows": rows, "outputs_bit_equal": equal,
              "max_abs_err_vs_plain": plain_err, "tol": TOL[dtype],
              "launches": ops.launch_counts(),
              "launches_by_route": ops.route_counts()}
    if dev.type == "cuda":
        record["k3_call"] = _k3_call(tree, x, order, dev)
    record["device"] = device_record(dev)
    if keep_outputs:
        record["_outputs"] = outputs
        record["_workload"] = (tree_np, x_np, order)
    return record


def _against_plain(tree, x, order, outputs, dev, dtype) -> float:
    """Layout A's outputs against K3's plain version on the same inputs;
    raises past ``TOL``.  Returns the largest absolute difference."""
    err = 0.0
    for i, got in zip(order, outputs):
        w = [tree[f"expert{i}"][k].to(dev)[None] for k in ("w1", "w3", "w2")]
        want = moe_ffn_ref(x[None], *w)[0].float().cpu()
        diff = (got.float() - want).abs()
        if bool((diff > TOL[dtype] * (1 + want.abs())).any()):
            raise AssertionError(f"layout A's call of expert {i} differs "
                                 f"from the plain version by "
                                 f"{float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def _k3_call(tree, x, order, dev) -> Dict[str, object]:
    """One K3 call of the pass on resident weights: device ms by CUDA
    events (the calls cycle through the pass's experts, so each reads its
    weights as the pass does) against the bytes it must move."""
    w = {i: [tree[f"expert{i}"][k].to(dev)[None] for k in ("w1", "w3", "w2")]
         for i in sorted(set(order))}
    it = {"i": 0}

    def call():
        it["i"] += 1
        return ops.moe_ffn(x[None], *w[order[it["i"] % len(order)]])

    c, d = x.shape
    f = w[order[0]][0].shape[2]
    b_ms, b_by = bound_ms(3 * d * f * 2 + 2 * c * d * 2, 6 * c * d * f,
                          "bfloat16")
    return {"E": 1, "C": c, "d": d, "f": f, "route": route(x.dtype, d, f),
            "ms": events_ms(call, 48), "bound_ms": b_ms, "bound_by": b_by}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's size: 16 experts, d 64, f 256, "
                         "fp32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    write_out(run(full=not args.reduced, device=args.device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
