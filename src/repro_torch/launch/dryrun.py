"""Dry runs of the serving programs on ``meta`` tensors (the serving half
of ``repro/launch/dryrun.py``).

The reference lowers and compiles every program of an ``EngineConfig``
against ShapeDtypeStruct stand-ins and prices the compiled HLO.  The port
runs each program function once on ``meta`` tensors (shapes, no storage)
and counts it (:func:`repro_torch.launch.cost.count`): nothing is
allocated and no kernel launched, so it needs no card.  This is how the
autotuner's cost model prices knob settings that change a program's
shape (another horizon H, kv_block, spec_k, batch) without running them.

From the command line, one engine config's programs, counted and priced
against the H100's peaks, as one JSON line (no card needed)::

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b [--full]
        [--batch 4] [--max-len 128] [--prefill-len 64] [--horizon 16]
        [--spec-k 3] [--programs decode,verify]

The reference's multi-pod half (``compile_cell``, ``run_cell`` and its
command line: every arch x shape cell lowered over a 16x16 or 2x16x16
mesh, with its collectives parsed from the HLO) waits for tensor
parallelism, ROADMAP Queue 1 item 13, and the training cells for item 14.
The single-card counts of every cell are ``repro_torch.bench.roofline``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch import steps as steps_lib
from repro_torch.engine_config import EngineConfig, HorizonConfig, SpecConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost import count, tensors
from repro_torch.models import layers, registry, transformer

__all__ = ["input_specs", "lower_serve_programs", "serve_trees",
           "tree_bytes", "out_shapes"]


def input_specs(arch: str, shape: str, **kw):
    """Every argument of a cell's step function as a ``meta`` tensor
    (:func:`repro_torch.models.registry.cell_spec`)."""
    return registry.cell_spec(arch, shape, **kw).abstract_args


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def out_shapes(tree):
    """An output tree as its (shape, dtype name) pairs."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    if isinstance(tree, dict):
        return {k: out_shapes(v) for k, v in tree.items()}
    return type(tree)(out_shapes(v) for v in tree)


def serve_trees(cfg, config):
    """The engine's parameter and cache trees for ``config``, on
    ``meta``: the parameters from ``abstract_params`` (a ``meta`` device
    has no generator to draw from), the caches as the engine lays them
    out (paged, or flat windowed buffers under ``spec``)."""
    params = layers.zeros(transformer.abstract_params(cfg),
                          layers.torch_dtype(cfg.dtype), registry.META)
    if config.paged:
        caches = transformer.init_paged_cache(
            cfg, config.batch, config.max_len,
            kv_block=config.paging.kv_block,
            arena_blocks=config.paging.resolved_arena_blocks(
                config.batch, config.max_len), device=registry.META)
    else:
        caches = transformer.init_cache(cfg, config.batch, config.max_len,
                                        ring=config.spec is None,
                                        device=registry.META)
    return params, caches


def lower_serve_programs(arch: str, config,
                         programs: Optional[Iterable[str]] = None
                         ) -> Dict[str, Dict[str, Any]]:
    """Count the serving programs an ``EngineConfig`` would hot-load,
    without allocating parameters or caches.

    Builds ``steps.serve_program_specs`` over ``meta`` trees (the
    programs a live engine of ``config`` binds: ``prefill`` only with
    ``group_prefill``, ``prefill_offset`` only with ``prefix`` on an
    attention-only arch) and runs each once under
    :func:`~repro_torch.launch.cost.count`.  ``programs`` optionally
    restricts to a subset of names.

    Returns ``{name: record}`` with, per program:
      cost       :class:`repro_torch.launch.cost.Cost` of one call
      out_shape  output tree of (shape, dtype) pairs
      memory     ``argument_bytes`` (the resident trees and the inputs)
                 and ``output_bytes``; ``temp_bytes`` is None: a ``meta``
                 run allocates nothing, so it knows no peak of its own
      count_s    host seconds the count took
    """
    cfg = registry.get_config(arch, reduced=config.reduced)
    params, caches = serve_trees(cfg, config)
    specs = steps_lib.serve_program_specs(cfg, config, params, caches)
    wanted = None if programs is None else set(programs)
    out = {}
    for name, spec in specs.items():
        if wanted is not None and name not in wanted:
            continue
        args = (*spec.resident, *spec.inputs)
        t0 = time.perf_counter()
        cost, result = count(spec.fn, *args)
        count_s = time.perf_counter() - t0
        out[name] = {
            "cost": cost,
            "out_shape": out_shapes(result),
            "memory": {"argument_bytes": tree_bytes(args),
                       "output_bytes": tree_bytes(result),
                       "temp_bytes": None},
            "count_s": count_s,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.PORTED_ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-len", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=None)
    ap.add_argument("--programs", default=None,
                    help="comma-separated program names (default: all)")
    args = ap.parse_args(argv)
    config = EngineConfig(
        reduced=not args.full, batch=args.batch, max_len=args.max_len,
        prefill_len=args.prefill_len,
        horizon=(HorizonConfig(length=args.horizon)
                 if args.horizon is not None else None),
        spec=SpecConfig(k=args.spec_k) if args.spec_k is not None else None)
    dtype = registry.get_config(args.arch, reduced=not args.full).dtype
    recs = lower_serve_programs(
        args.arch, config,
        args.programs.split(",") if args.programs else None)
    out = {}
    for name, rec in recs.items():
        cost = rec["cost"]
        out[name] = dict(cost.to_dict(), out_shape=rec["out_shape"],
                         memory=rec["memory"], count_s=rec["count_s"],
                         **rl.roofline_terms(cost.flops, cost.bytes_ideal,
                                             0.0, dtype=dtype))
    print(json.dumps({"arch": args.arch, "dtype": dtype,
                      "config": config.to_dict(), "device": rl.DEVICE,
                      "programs": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
