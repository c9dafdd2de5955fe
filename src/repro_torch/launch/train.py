"""End-to-end trainer on the persistent executor (port of
``repro/launch/train.py``, the dense decoder-only family).

It wires the port's layers together:

  syscore      the train program is hot-loaded once (on the card: warmed
               up, then captured as one CUDA graph over the resident
               train state) and re-executed every step;
  hostcall     the per-step (step, loss) report is a host call made from
               inside the program (a host node of the graph on the card),
               or, with ``in_graph_telemetry=False``, dispatched by the
               host after the step;
  checkpoint   atomic saves every ``ckpt_every`` steps; a restart copies
               the newest one back into the resident state;
  runtime      restart-on-failure supervision and a straggler monitor;
  data         the deterministic, restartable token pipeline.

The resident state is allocated once: the program is hot-loaded first (its
warm-up runs one step on the resident tree), then the state is initialised
or restored *into* that storage, never rebound, so the captured graph keeps
reading and writing it.  There is no fallback: a capture that fails
raises, and ``device="cuda"`` without a card raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \
      --steps 40 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \
      --batch 4 --seq 1024 --ckpt-every 10 --fail-at 15    (on the card)
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch import steps as steps_lib
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.core.hostcall import CALL_STEP_REPORT
from repro_torch.core.syscore import Syscore
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import registry
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (FaultInjector, StragglerMonitor,
                                 run_with_restarts)

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def init_into(state, cfg, seed: int):
    """Fresh weights from ``seed`` and zero optimizer state, copied into
    ``state``'s own tensors (their storage kept)."""
    params = steps_lib.model_module(cfg).init_params(
        cfg, seed, device=state["opt"]["step"].device)
    with torch.no_grad():
        for dst, src in zip(steps_lib.leaves(state["params"]),
                            steps_lib.leaves(params)):
            dst.copy_(src)
        for name in ("m", "v"):
            for t in steps_lib.leaves(state["opt"][name]):
                t.zero_()
        state["opt"]["step"].zero_()


def train(arch: str, *, reduced: bool = True, steps: int = 100,
          global_batch: int = 8, seq_len: int = 128,
          ckpt_dir=DEFAULT_CKPT_DIR, ckpt_every: int = 25, fail_at=(),
          lr: float = 1e-3, accum: int = 1, mesh=None, log_every: int = 10,
          seed: int = 0, max_restarts: int = 4,
          in_graph_telemetry: bool = True, device="cuda",
          config=None, on_program=None):
    """Train ``arch`` for ``steps`` steps with restarts; returns the
    supervisor's result with the losses, telemetry and program reports.
    ``config`` replaces the registry's config (a test's smaller one);
    ``on_program(handle, state, pipeline)`` is called once after the hot
    load, before the state is initialised (a measurement hook: its calls
    are not counted in ``steps_run`` nor in the telemetry)."""
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh (sharded training, the tree loader's restore) "
            "belongs to tensor parallelism, not ported yet (ROADMAP Queue "
            "1 item 13)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda'): no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    cfg = config if config is not None else registry.get_config(
        arch, reduced=reduced)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)

    monitor = StragglerMonitor()
    injector = FaultInjector(list(fail_at))
    manager = CheckpointManager(ckpt_dir, keep=2)
    # the checkpoint directory's program store is the job's global-memory
    # tier; a program with an in-graph host call cannot be exported, and
    # the store counts it as skipped (host telemetry makes it exportable
    # where torch.export takes the rest)
    sys_core = Syscore(device=device, store=manager.program_store)
    hct = sys_core.hostcalls
    pipeline = TokenPipeline(cfg, DataConfig(global_batch, seq_len, seed),
                             device=device)

    # ---- the resident state and the program, hot-loaded once -------------
    state = steps_lib.init_train_state(cfg, seed, device=device)
    base_step = steps_lib.make_train_step(cfg, opt_cfg, accum=accum)

    def train_step(state, batch):
        state, metrics = base_step(state, batch)
        # in-graph telemetry through the numbered host-call ABI
        hct.hostcall(CALL_STEP_REPORT, state["opt"]["step"],
                     metrics["loss"])
        return state, metrics

    program = steps_lib.make_train_program(
        cfg, opt_cfg, accum=accum,
        step_fn=train_step if in_graph_telemetry else None)
    spec = steps_lib.train_program_spec(
        cfg, opt_cfg, state,
        steps_lib.batch_templates(cfg, global_batch, seq_len, device),
        accum=accum, fn=program)
    train_prog = sys_core.hot_load(spec)
    if on_program is not None:
        on_program(train_prog, state, pipeline)
    # the warm-up (and a hook's calls) ran steps on the resident tree:
    # their reports are no training steps
    hct.step_times.clear()
    hct.step_stamps.clear()
    executions0 = train_prog.stats.executions
    keys = steps_lib.batch_keys(cfg)
    losses, grad_norms = [], []

    restore_s = []

    def loop(start_step: int) -> int:
        if manager.has_checkpoint():
            t0 = time.perf_counter()
            start_step = manager.restore_into(state) + 1
            restore_s.append(time.perf_counter() - t0)
        else:
            init_into(state, cfg, seed)
        for step, batch in pipeline.run(start_step, steps - start_step):
            injector.check(step)
            t0 = time.perf_counter()
            _, metrics = train_prog(state, *(batch[k] for k in keys))
            if device.type == "cuda":
                # waits with the interpreter lock released, so that the
                # graph's host node can take it
                torch.cuda.synchronize(device)
            loss = float(metrics["loss"])
            wall = time.perf_counter() - t0
            if not in_graph_telemetry:
                # the in-graph call's (step, loss) payload, so that the
                # CALL_STEP_REPORT channel is the same in both modes
                hct.dispatch(CALL_STEP_REPORT, step + 1, loss)
            monitor.observe(wall)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} gnorm "
                      f"{grad_norms[-1]:.3f} wall {wall * 1e3:.1f}ms",
                      flush=True)
            if step and step % ckpt_every == 0:
                manager.save(step, state, syscore=sys_core)
        manager.save(steps - 1, state, syscore=sys_core)
        return steps - 1

    def resume_step() -> int:
        s = latest_step(ckpt_dir)
        return 0 if s is None else s + 1

    result = run_with_restarts(
        loop, resume_step_fn=resume_step, max_restarts=max_restarts,
        on_restart=lambda n, e: print(f"[restart {n}] {e}: restoring the "
                                      f"newest checkpoint", flush=True))
    prog = train_prog.program
    result.update({
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "grad_norms": grad_norms,
        "straggler": monitor.summary(),
        "programs": sys_core.report()["programs"],
        "program_store": sys_core.store.report(),
        "export_error": prog.export_error,
        "telemetry_points": len(hct.step_times),
        "telemetry_errors": list(hct.errors),
        "executions": prog.stats.executions,
        "steps_run": prog.stats.executions - executions0,
        "checkpoint_save_s": list(manager.save_times),
        "checkpoint_restore_s": restore_s,
    })
    return result


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(
        description="Train through the port's persistent executor.")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.PORTED_ARCHS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published config instead of the reduced one")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--host-telemetry", action="store_true",
                    help="report step telemetry from the host instead of "
                         "by an in-graph host call, which lets the store "
                         "try to export the train program")
    args = ap.parse_args(argv)
    res = train(args.arch, reduced=args.reduced, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                accum=args.accum, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                lr=args.lr, seed=args.seed, log_every=args.log_every,
                in_graph_telemetry=not args.host_telemetry,
                device=args.device)
    print({k: v for k, v in res.items()
           if k not in ("programs", "losses", "grad_norms")})
    return res


if __name__ == "__main__":
    main()
