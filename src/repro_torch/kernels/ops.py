"""Public kernel entry points of the port (mirrors ``repro/kernels/ops.py``).

There is no implementation switch: the device of the tensors decides.  A
CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor launches
the hand-written Hopper kernel or raises.  Every TPU kernel of the
reference has its counterpart here (K1-K5), and K1, K2, K3 and K5 have
gradients (K1's backward counts under K1 and K3's under K3, each on
route "bwd_wgmma" or "bwd_simt"; K5's under K5, on route "bwd", its
forward on "fwd").
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.moe_dispatch import (moe_ffn, moe_ffn_bwd,
                                              moe_ffn_bwd_ref, moe_ffn_ref)
from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                            rglru_scan_bwd_ref,
                                            rglru_scan_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

KERNELS = {"matmul": matmul, "flash_attention": flash_attention,
           "moe_ffn": moe_ffn, "ssd_scan": ssd_scan,
           "rglru_scan": rglru_scan}

__all__ = ["matmul", "matmul_ref", "flash_attention", "flash_attention_ref",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "moe_ffn", "moe_ffn_ref", "moe_ffn_bwd", "moe_ffn_bwd_ref",
           "ssd_scan", "ssd_scan_ref",
           "rglru_scan", "rglru_scan_ref", "rglru_scan_bwd",
           "rglru_scan_bwd_ref", "KERNELS", "launch_counts",
           "route_counts", "reset_launch_counts", "add_launch_counts"]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches by route since the last reset, for the kernels with more
    than one route (K1, K3, K4) or a backward (K5: "fwd" and "bwd")."""
    return {name: dict(fn.launches_by_route) for name, fn in KERNELS.items()
            if hasattr(fn, "launches_by_route")}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def add_launch_counts(launches: Dict[str, int],
                      routes: Dict[str, Dict[str, int]], times: int = 1):
    """Add ``times`` x ``launches`` (and ``routes``, by route) to the
    kernels' counters: the launches of a replayed CUDA graph, which the
    wrappers count only while it is captured."""
    for name, n in launches.items():
        KERNELS[name].launches += times * n
    for name, by_route in routes.items():
        counts = KERNELS[name].launches_by_route
        for r, n in by_route.items():
            counts[r] += times * n
