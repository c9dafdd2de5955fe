"""What the port's benches share: the device they ran on and medians."""
from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict, Optional

import torch


# H100 SXM peaks (NVIDIA data sheet, dense): memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; fp32 outside the tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    """The least time the card could take: the larger of ``nbytes`` over
    its memory rate and ``flops`` over its peak for the dtype; with what
    bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_record(device: torch.device) -> Dict[str, object]:
    """The device a bench ran on: the card's name, count and power limit
    (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def write_out(record: Dict[str, object], out: Optional[str]):
    """Print ``record`` as one JSON line; write it to ``out`` too, where
    one is given (a bench writes no other file)."""
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_s(fn: Callable[[], object], device: torch.device, n: int,
             warmup: int = 1) -> float:
    """Median host seconds of ``fn()`` ended by a synchronize, over ``n``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2]


def events_ms(fn: Callable[[], object], n: int) -> float:
    """Mean device ms of ``fn()`` on the card by CUDA events around ``n``
    back-to-back calls, behind a sleep kernel that holds the card while
    the host queues them (so the events time the device, not the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9 * (1.5 * enqueue_s * n + 1e-4), 4e8)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n
