"""K5: the RG-LRU linear recurrence of every recurrent ("R") layer's
prefill.

``rglru_scan(a, b, h0)`` replaces the Pallas kernel
``repro/kernels/rglru_scan.py:rglru_scan`` with the CUDA C++ kernel in
``csrc/rglru_scan.cu`` (its header says what bounds it).  It computes
``h_t = a_t * h_{t-1} + b_t`` over S from ``h_{-1} = h0``: a and b are
(B,S,L) fp32 and contiguous, h0 (B,L) fp32 or None (zeros).  Returns h
(B,S,L) and the final state (B,L), both fp32.  Unlike the Pallas kernel,
which starts from zero, the kernel takes h0 itself, so the model does not
fold it in as a virtual step; a ragged S and L are masked (the Pallas
kernel asserts that its tiles divide them).

CPU tensors take :func:`rglru_scan_ref`; CUDA tensors launch the kernel or
raise.  ``rglru_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the sequential loop of ``repro/kernels/ref.py:
    rglru_scan``, from h0.  Each step is a product and a sum, two separate
    ops, the kernel's rounding (it forbids the fused multiply-add)."""
    bsz, s, l = a.shape
    hs = torch.zeros((bsz, l), dtype=torch.float32, device=a.device) \
        if h0 is None else h0
    out = torch.empty((bsz, s, l), dtype=torch.float32, device=a.device)
    for t in range(s):
        hs = a[:, t] * hs + b[:, t]
        out[:, t] = hs
    return out, hs


def _check(a, b, h0):
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan takes a and b of one shape (B,S,L), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan h0 must be {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, h0) if t is not None):
        raise TypeError(f"rglru_scan takes a, b and h0 in float32, got "
                        f"{a.dtype}, {b.dtype}"
                        f"{'' if h0 is None else ', ' + str(h0.dtype)}")
    if len({t.device for t in (a, b, h0) if t is not None}) != 1:
        raise ValueError("rglru_scan operands on different devices")
    if min(a.shape) < 1:
        raise ValueError(f"rglru_scan needs non-empty operands, got "
                         f"{tuple(a.shape)}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h (B,S,L), h_final (B,L)) of the recurrence from state h0."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan has no route for device {a.device}")
    if not all(t.is_contiguous() for t in (a, b, h0) if t is not None):
        raise ValueError("rglru_scan kernel needs contiguous a, b and h0")
    bsz, s, l = a.shape
    lib = _build.library()
    h = torch.empty_like(a)
    hf = torch.empty((bsz, l), dtype=torch.float32, device=a.device)
    err = lib.repro_rglru_scan(
        a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
        h.data_ptr(), hf.data_ptr(), bsz, s, l, _build.stream_handle())
    _build.check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h, hf


rglru_scan.launches = 0
