"""Quickstart: the persistent executor on the port, the counterpart of
``examples/quickstart.py``.

The paper's runtime model end to end on one device:
  1. boot the Syscore once,
  2. hot-load a train program ahead of time (on the card: warmed up, then
     captured as one CUDA graph over the resident train state),
  3. re-execute it many times (the fast path of Table 1),
  4. per-step telemetry through an in-graph host call,
  5. a placement report for the model's parameters.

Run from the repository root (``PYTHONPATH=src``)::

    python -m repro_torch.examples.quickstart [--device cuda] [--steps 10]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import steps
from repro_torch.core.hostcall import CALL_STEP_REPORT
from repro_torch.core.placement import USRMEM, PlacementPlan, apply_plan
from repro_torch.core.syscore import Syscore, cold_execute
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = registry.get_config(args.arch, reduced=True)
    sc = Syscore(device=dev)

    state = steps.init_train_state(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    base = steps.make_train_step(cfg, AdamWConfig())

    def train_step(state, batch):
        state, metrics = base(state, batch)
        sc.hostcalls.hostcall(CALL_STEP_REPORT, state["opt"]["step"],
                              metrics["loss"])
        return state, metrics

    program = steps.make_train_program(cfg, AdamWConfig(),
                                       step_fn=train_step)
    spec = steps.train_program_spec(cfg, AdamWConfig(), state, batch,
                                    fn=program)
    t0 = time.perf_counter()
    train_prog = sc.hot_load(spec)
    print(f"hot_load (warm-up + capture once): "
          f"{time.perf_counter() - t0:.2f}s")
    # the card's warm-up ran one step: start again from the draw's weights
    fresh = steps.init_train_state(cfg, 0, device=dev)
    with torch.no_grad():
        for dst, src in zip(steps.leaves(state), steps.leaves(fresh)):
            dst.copy_(src)
    sc.hostcalls.step_times.clear()

    args_ = [batch[k] for k in steps.batch_keys(cfg)]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        _, metrics = train_prog(state, *args_)
    loss = float(metrics["loss"])
    print(f"re-execute x{args.steps}: "
          f"{(time.perf_counter() - t0) / args.steps * 1e3:.1f} ms/step, "
          f"loss={loss:.3f}")
    print(f"handle stats: {train_prog.stats.executions} executions, "
          f"last {train_prog.stats.last_exec_s * 1e3:.1f} ms")
    telemetry = len(sc.hostcalls.step_times)

    t0 = time.perf_counter()
    cold_execute(program, state, *args_)
    print(f"cold warm-up+capture+exec (eSDK analogue): "
          f"{time.perf_counter() - t0:.2f}s")
    print("telemetry points via hostcall:", telemetry)

    plan = PlacementPlan().add(r"embed", USRMEM)   # embeddings host-resident
    placed = apply_plan(state["params"], plan, device=dev)
    print("placement report:", placed.report()["fraction"])
    print("programs:", sc.report()["programs"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
