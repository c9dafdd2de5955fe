"""Roofline of every (arch x shape) cell on one NVIDIA H100, from counts on
``meta`` tensors (the counterpart of ``benchmarks/bench_roofline.py`` and
``repro/launch/report.py``).

The reference reads the records of its multi-pod dry run (every cell
lowered and compiled for a TPU mesh) and reports per cell the roofline
terms, the dominant one, whether the cell fits a chip's memory and the
analytic MODEL_FLOPS over the counted FLOPs.  The port counts each cell's
program (``registry.build_step_fn``: the whole-batch prefill, the decode
step or the train program) once on ``meta`` tensors (:mod:`repro_torch.launch.cost`), so no
parameter is allocated and no card is needed, and prices it against the
H100's published peaks (:mod:`repro_torch.launch.roofline`).  Per cell:
FLOPs, ideal bytes, ``compute_s``, ``memory_s``, the dominant term,
whether the parameters and caches (a train cell: the parameters and the
fp32 moments) fit one card's 80 GB, and ``model_flops`` over the counted
FLOPs.  The ``train_4k`` cells of the dense, MoE and hybrid families
are counted through the train program (forward, the recompute its
``remat_policy`` asks for, K2's dX and dW products, K1's, K3's and K5's
backward, AdamW); those of the SSM and encoder-decoder families are
listed as waiting for their training step (ROADMAP Queue 1 items 14b.3
and 14b.4); the reference's 500k-token
cells of the full-attention archs are skipped as the reference skips
them.

``--reduced`` counts the reduced configs at the reference's reduced cell
size (64 tokens, batch 4), in fp32; ``--smoke`` counts the ``decode_32k``
cells only.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.bench.roofline [--reduced] [--smoke] [--out PATH]

prints one JSON line; ``--out`` also writes it to PATH.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

from repro_torch import steps
from repro_torch.bench.common import write_out
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost import count
from repro_torch.launch.dryrun import tree_bytes
from repro_torch.models import registry


def count_cell(arch: str, shape: str, *, reduced: bool) -> Dict[str, object]:
    """One cell's counts and roofline terms."""
    spec = registry.cell_spec(arch, shape, reduced=reduced)
    t0 = time.perf_counter()
    cost, _ = count(registry.build_step_fn(spec), *spec.abstract_args)
    count_s = time.perf_counter() - t0
    terms = rl.roofline_terms(cost.flops, cost.bytes_ideal, 0.0,
                              dtype=spec.cfg.dtype)
    # params and caches; a train cell's state
    resident = tree_bytes(spec.abstract_args[:1 if spec.kind == "train"
                                             else 2])
    # MODEL_FLOPS at the cell's own size (a reduced cell is 64 x 4)
    seq, batch, kind = registry.SHAPES[shape]
    scale = spec.global_batch / batch
    if kind in ("prefill", "train"):
        scale *= spec.seq_len / seq
    mflops = registry.model_flops(spec.cfg, shape) * scale
    return {
        "arch": arch, "shape": shape, "kind": spec.kind,
        "seq_len": spec.seq_len, "batch": spec.global_batch,
        "dtype": spec.cfg.dtype,
        "flops": cost.flops, "bytes_ideal": cost.bytes_ideal,
        "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
        "dominant": terms["dominant"],
        "roofline_fraction": terms["roofline_fraction"],
        "resident_bytes": resident,
        "fits_one_card": resident <= rl.HBM_BYTES,
        "model_flops": mflops,
        "model_flops_over_counted": mflops / cost.flops,
        "count_s": count_s,
    }


def run(*, reduced: bool = False, smoke: bool = False) -> Dict[str, object]:
    cells, waiting = [], []
    for arch, shape in registry.all_cells():
        kind = registry.SHAPES[shape][2]
        why = (steps.train_unsupported(registry.get_config(arch))
               if kind == "train" else None)
        if why is not None:
            waiting.append({"arch": arch, "shape": shape, "waits_for": why})
            continue
        if smoke and shape != "decode_32k":
            continue
        cells.append(count_cell(arch, shape, reduced=reduced))
    worst = min(cells, key=lambda c: c["roofline_fraction"])
    return {
        "bench": "roofline", "reduced": reduced, "smoke": smoke,
        "device": rl.DEVICE,
        "peaks": {"flops": rl.PEAK_FLOPS, "hbm_bytes_per_s":
                  rl.HBM_BYTES_PER_S, "hbm_bytes": rl.HBM_BYTES},
        "cells": cells,
        "waiting": waiting,
        "skipped": [{"arch": a, "shape": s,
                     "reason": registry.cell_skip_reason(
                         registry.get_config(a), s)}
                    for a, s in registry.all_cells(include_skipped=True)
                    if registry.cell_skip_reason(registry.get_config(a), s)],
        "cells_fitting_one_card": sum(c["fits_one_card"] for c in cells),
        "worst_cell": {"arch": worst["arch"], "shape": worst["shape"],
                       "roofline_fraction": worst["roofline_fraction"]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    write_out(run(reduced=args.reduced, smoke=args.smoke), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
