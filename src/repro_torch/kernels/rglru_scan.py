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

The scan is segmented: S splits into ``SEGMENTS`` runs of
:func:`segment_len` steps (a function of S alone), each folded from zero
into a pair (product of a, value from zero), the pairs folded in
ascending order into each segment's carry-in, and each segment walked
again from its carry-in.  The kernel and :func:`rglru_scan_ref` take the
same steps in the same order, so they agree bit for bit; against the
sequential loop of the reference they differ by rounding alone.

CPU tensors take :func:`rglru_scan_ref`; CUDA tensors launch the kernel or
raise.  ``rglru_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SEGMENTS = 8       # segments of S: the kernel's warps a block


def segment_len(s: int) -> int:
    """Steps of each segment of a scan over ``s`` steps (the last segments
    may be shorter or empty): ceil(s / SEGMENTS), a function of S alone."""
    return -(-s // SEGMENTS)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the recurrence of ``repro/kernels/ref.py:
    rglru_scan``, from h0, in the kernel's order, vectorised across the
    segments: pass 1 folds each segment from zero into (prod a, value),
    the pairs are folded in ascending order into each segment's carry-in,
    pass 2 walks each segment again from it.  Each step is a product and a
    sum, two separate ops, the kernel's rounding (it forbids the fused
    multiply-add); steps past S are skipped, not padded."""
    bsz, s, l = a.shape
    n = segment_len(s)
    pad = SEGMENTS * n - s
    # (B, SEGMENTS, n, L): segment k holds steps k*n .. k*n + n - 1
    ap = F.pad(a, (0, 0, 0, pad)).view(bsz, SEGMENTS, n, l)
    bp = F.pad(b, (0, 0, 0, pad)).view(bsz, SEGMENTS, n, l)
    valid = (torch.arange(SEGMENTS * n, device=a.device) < s).view(
        1, SEGMENTS, n, 1)
    pa = torch.ones((bsz, SEGMENTS, l), dtype=torch.float32, device=a.device)
    pb = torch.zeros_like(pa)
    for t in range(n):
        v = valid[:, :, t]
        pa = torch.where(v, ap[:, :, t] * pa, pa)
        pb = torch.where(v, ap[:, :, t] * pb + bp[:, :, t], pb)
    carry = torch.zeros((bsz, l), dtype=torch.float32, device=a.device) \
        if h0 is None else h0
    carries = []
    for k in range(SEGMENTS):
        carries.append(carry)
        carry = pa[:, k] * carry + pb[:, k]
    hs = torch.stack(carries, dim=1)                        # (B, SEG, L)
    out = torch.empty((bsz, SEGMENTS, n, l), dtype=torch.float32,
                      device=a.device)
    for t in range(n):
        hs = ap[:, :, t] * hs + bp[:, :, t]
        out[:, :, t] = hs
    out = out.view(bsz, SEGMENTS * n, l)[:, :s].contiguous()
    return out, out[:, s - 1].clone()


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
    return _rglru_scan_op(a, b, h0)


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                         device_types="cuda")
def _rglru_scan_op(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation: launch K5 on the current stream."""
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


@_rglru_scan_op.register_kernel("cpu")
def _(a, b, h0):
    return rglru_scan_ref(a, b, h0)


@_rglru_scan_op.register_fake
def _(a, b, h0):
    return a.new_empty(a.shape), a.new_empty((a.shape[0], a.shape[2]))


rglru_scan.launches = 0
