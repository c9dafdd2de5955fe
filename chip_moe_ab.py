#!/usr/bin/env python3
"""Compare two checkouts' olmoe-1b-7b train step on one card, step by step.

For each checkout, in turns A, B, B, A, each in a process of its own:
K3's forward alone at olmoe's training capacity (``chip_smoke.py``'s
``k3_forward_at_training_capacity``, twice), then phase 31's full-width
model (4 of 16 layers, 4 x 1,024 tokens, weights from seed 0) through
``launch.train``, whose hot-loaded step is profiled call by call for its
first 8 calls (each call is one more train step): the device ms of K3's
forward (the layers' forward calls and their recomputes in the backward,
apart), of K3's backward and of the whole step.  Then 20 more steps under
``nvidia-smi``'s sampling of the SM clock, the power and the throttle
reasons.  Prints one line a measurement.

    python3 chip_moe_ab.py DIR_A DIR_B

where each directory holds a checkout (``git archive`` of a commit,
unpacked).  Needs one card.
"""
import os
import shutil
import subprocess
import sys
import tempfile
import time

STEPS_PROFILED, STEPS_SAMPLED = 8, 20


class _Done(Exception):
    pass


def one(root: str) -> int:
    """The measurements of one checkout, in this process."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.launch.train import train
    from repro_torch.models import registry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"tree {root} on {smi}", flush=True)
    for _ in range(2):
        cs.k3_forward_at_training_capacity(torch, smi)
    cfg = registry.get_config(cs.MOE_TRAIN_ARCH).replace(
        n_layers=cs.MOE_TRAIN_LAYERS)

    def hook(handle, state, pipeline):
        batch = pipeline.device_batch(0)
        args = [batch[k] for k in ("tokens", "labels")]
        for i in range(STEPS_PROFILED):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                handle(state, *args)
                torch.cuda.synchronize()
            ms = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in sorted(prof.events(),
                                  key=lambda e: e.time_range.start)
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            # a K3 forward call is two kernels (gate-up, down); the
            # layers' forward calls come first, their recomputes after
            fwd = [t for name, t in ms if "moe_ffn_kernel" in name]
            calls = [round(a + b, 3) for a, b in zip(fwd[::2], fwd[1::2])]
            half = len(calls) // 2
            print(f"step {i}: K3 forward {sum(fwd):.3f} ms (forward "
                  f"{sum(calls[:half]):.3f}, recompute "
                  f"{sum(calls[half:]):.3f}; by call {calls}), K3 backward "
                  f"{sum(t for name, t in ms if 'moe_bwd' in name):.3f}, "
                  f"device {sum(t for _, t in ms):.3f}", flush=True)
        mon = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
             "clocks_throttle_reasons.active", "--format=csv,noheader,"
             "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
        try:
            time.sleep(0.5)
            for _ in range(STEPS_SAMPLED):
                handle(state, *args)
            torch.cuda.synchronize()
        finally:
            mon.terminate()
        rows = [line.split(", ") for line in
                mon.communicate(timeout=30)[0].strip().splitlines()]
        clock = sorted(float(r[0]) for r in rows)
        power = sorted(float(r[1]) for r in rows)
        print(f"{len(rows)} samples over {STEPS_SAMPLED} steps: SM clock "
              f"min {clock[0]} median {clock[len(clock) // 2]} MHz, power "
              f"median {power[len(power) // 2]} max {power[-1]} W, "
              f"throttle reasons {sorted({r[2] for r in rows})}",
              flush=True)
        raise _Done

    ckpt = tempfile.mkdtemp(prefix="chip_moe_ab_")
    try:
        train(cs.MOE_TRAIN_ARCH, config=cfg, steps=2,
              global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ,
              ckpt_dir=ckpt, ckpt_every=1000, lr=cs.TRAIN_LR,
              device="cuda", on_program=hook)
    except _Done:
        pass
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        return one(os.path.abspath(argv[1]))
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(d) for d in argv)
    rc = 0
    for name, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        print(f"== {name}", flush=True)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
