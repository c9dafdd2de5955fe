"""Dynamic-call expert paging (paper §3.4, contribution C4), on the port:
the counterpart of ``examples/moe_expert_paging.py``.

Serves an MoE layer whose expert weights exceed the device arena: the
experts live in host memory ("global memory"), the router is the jump
table, and the LRU arena of a
:class:`~repro_torch.core.dynamic_calls.PagedExpertStore` holds the hot
set.  Each routed call runs K3 (``ops.moe_ffn``) on the expert's
weights as the arena returns them.  The reference's draws, from
``numpy.random.default_rng(0)``: the reduced olmoe-1b-7b experts (fp32),
16 token rows and 40 calls from a skewed expert distribution.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.examples.moe_expert_paging [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.bench.common import sync
from repro_torch.core.dynamic_calls import DynamicCallTable, PagedExpertStore
from repro_torch.kernels import ops
from repro_torch.models import registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = registry.get_config("olmoe-1b-7b", reduced=True)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(0)

    # host-resident experts ("global memory")
    per_expert = 3 * d * f * 4
    experts = {}
    for i in range(e):
        experts[i] = {
            "w1": (rng.standard_normal((d, f)) * 0.05).astype(np.float32),
            "w3": (rng.standard_normal((d, f)) * 0.05).astype(np.float32),
            "w2": (rng.standard_normal((f, d)) * 0.05).astype(np.float32),
        }
    arena = DynamicCallTable(capacity_bytes=3 * per_expert, device=dev)
    store = PagedExpertStore(arena)
    for i in range(e):
        store.add_expert(0, i, {k: torch.from_numpy(v)
                                for k, v in experts[i].items()})
    print(f"{e} experts x {per_expert / 1e3:.0f}KB in host memory; "
          f"device arena = {arena.capacity / 1e3:.0f}KB (3 experts)")

    # routed calls with a skewed (realistic) expert distribution
    x = torch.from_numpy(
        (rng.standard_normal((16, d)) * 0.1).astype(np.float32)).to(dev)
    probs = np.exp(-0.7 * np.arange(e))
    probs /= probs.sum()
    for _ in range(40):
        eid = int(rng.choice(e, p=probs))
        w = store.lookup(0, eid)
        ops.moe_ffn(x[None], w["w1"][None], w["w3"][None], w["w2"][None])
    sync(dev)

    rep = arena.report()
    loads = sum(p["loads"] for p in rep["pages"].values())
    hits = sum(p["hits"] for p in rep["pages"].values())
    print(f"40 routed calls -> {loads} page loads, {hits} arena hits "
          f"({hits / (hits + loads):.0%} hit rate), "
          f"{rep['evictions']} evictions")
    print("hot set:", store.hot_set(3))
    print("resident:", arena.resident())
    arena.reset()
    print("after reset (paper's DC invalidation):", arena.resident())
    return 0


if __name__ == "__main__":
    sys.exit(main())
