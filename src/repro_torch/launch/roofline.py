"""Roofline terms of a counted program on one NVIDIA H100 (the port's
counterpart of ``repro/launch/roofline.py``, whose constants are a TPU
v5e's).

Two terms per program, in seconds a call, from :mod:`repro_torch.launch.cost`:

  compute = FLOPs / the card's peak for the program's dtype
  memory  = ideal HBM bytes / the card's memory rate

The peaks are NVIDIA's published figures for the H100 SXM (80 GB HBM3),
dense, at its full power limit of 700 W: 989 TFLOP/s in bf16 on the
tensor cores, 67 TFLOP/s in fp32 outside them, 3.35 TB/s of HBM.  A card
set below 700 W (``nvidia-smi --query-gpu=name,power.limit``) runs below
them, so a share against these peaks names the card's limit beside it.

The collective term is 0 on one card.  Its wire model
(``parse_collectives`` of the reference, NVLink on the H100) comes with
tensor parallelism, ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

from typing import Dict

DEVICE = "NVIDIA H100 80GB HBM3 (SXM), 700 W"
HBM_BYTES = 80e9             # one card's memory
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

__all__ = ["DEVICE", "HBM_BYTES", "HBM_BYTES_PER_S", "PEAK_FLOPS",
           "roofline_terms"]


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_intra: float, wire_bytes_cross: float = 0.0,
                   dtype: str = "bfloat16") -> Dict[str, float]:
    """The reference's keys: ``compute_s``, ``memory_s``,
    ``collective_s``, ``dominant`` and ``roofline_fraction`` (compute
    over the largest term).  The wire bytes must be 0 until item 13."""
    if wire_bytes_intra or wire_bytes_cross:
        raise NotImplementedError(
            "collectives on the H100 (NVLink) come with tensor "
            "parallelism, ROADMAP Queue 1 item 13")
    compute = flops_per_dev / PEAK_FLOPS[dtype]
    memory = bytes_per_dev / HBM_BYTES_PER_S
    collective = 0.0
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": collective,
        "dominant": dominant,
        "roofline_fraction": compute / bound if bound > 0 else 0.0,
    }
