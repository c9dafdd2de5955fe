"""K5: the RG-LRU linear recurrence of every recurrent ("R") layer's
prefill and training forward, and its gradient.

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

The operator has a gradient: :func:`rglru_scan_bwd`, the
``repro_torch::rglru_scan_bwd`` operator, whose CUDA kernel is in
``csrc/rglru_scan_bwd.cu`` (its header gives the design and the bound):
the adjoint recurrence walked backwards in time over the same segments,
with the carries folded in descending order.  Its CPU kernel is
:func:`rglru_scan_bwd_ref`, which takes the kernel's steps, so the two
agree bit for bit too.  The reference has no kernel for it: JAX
differentiates its associative scan.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  ``rglru_scan.launches`` counts kernel launches, forward and
backward, and ``rglru_scan.launches_by_route`` the same by direction
("fwd", "bwd").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SEGMENTS = 8       # segments of S: the kernel's warps a block
ROUTES = ("fwd", "bwd")   # the counters' keys: the forward, the backward


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
    rglru_scan.launches_by_route["fwd"] += 1
    return h, hf


@_rglru_scan_op.register_kernel("cpu")
def _(a, b, h0):
    return rglru_scan_ref(a, b, h0)


@_rglru_scan_op.register_fake
def _(a, b, h0):
    return a.new_empty(a.shape), a.new_empty((a.shape[0], a.shape[2]))


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       h0: Optional[torch.Tensor], dh: torch.Tensor,
                       dhf: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the recurrence's gradient, in the kernel's order,
    vectorised across the segments.  The adjoint lam_t = dh_t + a_{t+1}
    lam_{t+1} from lam_{S-1} = dh_{S-1} + dhf is the forward's recurrence
    walked from the last step with the coefficient c_t = a_{t+1} (1 at
    t = S - 1) and the start dhf (zeros where None): pass 1 folds each
    segment from its last step down, from zero, into (prod c, value), the
    pairs are folded in descending order into each segment's carry, pass 2
    walks each segment down again from it.  Each step is a product and a
    sum, two separate ops (the kernel forbids the fused multiply-add);
    steps past S are skipped.  Returns (da, db, dh0): db_t = lam_t, da_t =
    lam_t h_{t-1} (h_{-1} = h0, zeros where None), dh0 = a_0 lam_0."""
    bsz, s, l = a.shape
    n = segment_len(s)
    pad = SEGMENTS * n - s
    zeros = torch.zeros((bsz, 1, l), dtype=torch.float32, device=a.device)
    c = torch.cat([a[:, 1:], torch.ones_like(zeros)], dim=1)
    prev = torch.cat([zeros if h0 is None else h0[:, None], h[:, :-1]],
                     dim=1)
    # (B, SEGMENTS, n, L): segment k holds steps k*n .. k*n + n - 1
    cp, dp, hp = (F.pad(t, (0, 0, 0, pad)).view(bsz, SEGMENTS, n, l)
                  for t in (c, dh, prev))
    valid = (torch.arange(SEGMENTS * n, device=a.device) < s).view(
        1, SEGMENTS, n, 1)
    pa = torch.ones((bsz, SEGMENTS, l), dtype=torch.float32, device=a.device)
    pb = torch.zeros_like(pa)
    for t in reversed(range(n)):
        v = valid[:, :, t]
        pa = torch.where(v, cp[:, :, t] * pa, pa)
        pb = torch.where(v, cp[:, :, t] * pb + dp[:, :, t], pb)
    carry = zeros[:, 0] if dhf is None else dhf
    carries = [None] * SEGMENTS
    for k in reversed(range(SEGMENTS)):
        carries[k] = carry
        carry = pa[:, k] * carry + pb[:, k]
    lam = torch.stack(carries, dim=1)                       # (B, SEG, L)
    da = torch.empty((bsz, SEGMENTS, n, l), dtype=torch.float32,
                     device=a.device)
    db = torch.empty_like(da)
    for t in reversed(range(n)):
        lam = torch.where(valid[:, :, t], cp[:, :, t] * lam + dp[:, :, t],
                          lam)
        db[:, :, t] = lam
        da[:, :, t] = lam * hp[:, :, t]
    da, db = (t.view(bsz, SEGMENTS * n, l)[:, :s].contiguous()
              for t in (da, db))
    return da, db, a[:, 0] * lam[:, 0]


def _check_bwd(a, h, h0, dh, dhf):
    _check(a, h, h0)
    for name, t, shape in (("dh", dh, tuple(a.shape)),
                           ("dhf", dhf, (a.shape[0], a.shape[2]))):
        if t is not None and (tuple(t.shape) != shape or
                              t.dtype != torch.float32 or
                              t.device != a.device):
            raise ValueError(f"rglru_scan_bwd takes {name} {shape} float32 "
                             f"on {a.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dhf: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(da, db, dh0) of ``rglru_scan(a, b, h0)`` whose output was ``h``,
    for the gradients ``dh`` of h and ``dhf`` of the final state (None:
    zeros), through the ``repro_torch::rglru_scan_bwd`` operator."""
    _check_bwd(a, h, h0, dh, dhf)
    return _rglru_scan_bwd_op(a, h, h0, dh, dhf)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _rglru_scan_bwd_op(a: torch.Tensor, h: torch.Tensor,
                       h0: Optional[torch.Tensor], dh: torch.Tensor,
                       dhf: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA implementation: launch K5's backward on the current
    stream."""
    if not all(t.is_contiguous() for t in (a, h, h0, dh, dhf)
               if t is not None):
        raise ValueError("rglru_scan_bwd kernel needs contiguous a, h, h0, "
                         "dh and dhf")
    bsz, s, l = a.shape
    lib = _build.library()
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty((bsz, l), dtype=torch.float32, device=a.device)
    err = lib.repro_rglru_scan_bwd(
        a.data_ptr(), h.data_ptr(), h0.data_ptr() if h0 is not None else None,
        dh.data_ptr(), dhf.data_ptr() if dhf is not None else None,
        da.data_ptr(), db.data_ptr(), dh0.data_ptr(), bsz, s, l,
        _build.stream_handle())
    _build.check(err, "rglru_scan_bwd")
    rglru_scan.launches += 1
    rglru_scan.launches_by_route["bwd"] += 1
    return da, db, dh0


@_rglru_scan_bwd_op.register_kernel("cpu")
def _(a, h, h0, dh, dhf):
    return rglru_scan_bwd_ref(a, h, h0, dh, dhf)


@_rglru_scan_bwd_op.register_fake
def _(a, h, h0, dh, dhf):
    return (a.new_empty(a.shape), a.new_empty(a.shape),
            a.new_empty((a.shape[0], a.shape[2])))


def _setup_context(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, h0, output[0])


def _backward(ctx, dh, dhf):
    # autograd hands an unused output's gradient over as zeros: a loss on
    # h alone (the training forward's) gives dhf 0
    a, h0, h = ctx.saved_tensors
    da, db, dh0 = rglru_scan_bwd(a, h, h0, dh.contiguous(),
                                 dhf.contiguous())
    return da, db, None if h0 is None else dh0


_rglru_scan_op.register_autograd(_backward, setup_context=_setup_context)

rglru_scan.launches = 0
rglru_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
