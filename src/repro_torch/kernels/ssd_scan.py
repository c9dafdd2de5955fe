"""K4: the Mamba-2 SSD chunked scan of every SSM layer's prefill.

``ssd_scan(x, dt, a, b, c, h0)`` replaces the Pallas kernel
``repro/kernels/ssd_scan.py:ssd_scan`` with the CUDA C++ kernel in
``csrc/ssd_scan.cu`` (its header says what bounds it).  x is (B,S,H,P),
dt (B,S,H) fp32 after the softplus, a (H,) fp32 (negative), b and c
(B,S,N) in x's dtype, h0 (B,H,P,N) fp32 or None (zeros).  Returns y
(B,S,H,P) in x's dtype and the final state (B,H,P,N) in fp32; the D-skip
stays with the caller (``models/ssm.py``).  The scan runs in chunks of
``chunk`` positions, the last one ragged where ``chunk`` does not divide S
(the Pallas kernel asserts that it does).  x, b, c and dt may be strided
views with a contiguous last axis, as the layer's splits leave them.

CPU tensors take :func:`ssd_scan_ref`; CUDA tensors launch the kernel or
raise (also where one block's shared memory cannot hold a chunk: see
:func:`smem_bytes`).  ``ssd_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 128        # the reference's SSD_CHUNK and the Pallas default
MAX_CHUNK = 128    # the kernel's largest chunk (its thread count is 256)
STATE_ROWS = 16    # state rows (P) per block: csrc/ssd_scan.cu PT
SMEM_LIMIT = 232448


def smem_bytes(q: int, n: int) -> int:
    """Dynamic shared memory of one block at chunk ``q`` and state width
    ``n`` (csrc/ssd_scan.cu ``smem_floats``): C and B chunks and the state
    rows padded to n + 1 columns, the (q, q + 1) weights, the x tile and
    four (q,) vectors, all fp32."""
    return 4 * (2 * q * (n + 1) + q * (q + 1) + q * STATE_ROWS
                + STATE_ROWS * (n + 1) + 4 * q)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 h0: Optional[torch.Tensor] = None, *,
                 chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the Pallas kernel's numerics
    (``repro/kernels/ssd_scan.py:_kernel``), chunk by chunk: the decay
    cumsum in fp32, the exponent masked before the ``exp``, fp32 products,
    the (Q, Q) weights cast to x's dtype before the product with x, the
    state in fp32 and y rounded once to x's dtype."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = a.float()
    hs = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if h0 is None else h0.float())
    ys = []
    for s0 in range(0, s, chunk):
        xk = x[:, s0:s0 + chunk]                              # (B,Q,H,P)
        dtk = dt[:, s0:s0 + chunk].float()                    # (B,Q,H)
        bk = b[:, s0:s0 + chunk].float()                      # (B,Q,N)
        ck = c[:, s0:s0 + chunk].float()
        q = xk.shape[1]
        cs = torch.cumsum(dtk * a, dim=1)                     # inclusive
        seg = cs[:, :, None, :] - cs[:, None, :, :]           # (B,Qi,Qj,H)
        causal = torch.ones((q, q), dtype=torch.bool,
                            device=x.device).tril()
        lmat = torch.exp(torch.where(causal[None, :, :, None], seg,
                                     torch.full_like(seg, -1e30)))
        cb = torch.einsum("bin,bjn->bij", ck, bk)
        att = (cb[..., None] * lmat * dtk[:, None, :, :]).to(x.dtype)
        y_intra = torch.einsum("bijh,bjhp->bihp", att.float(), xk.float())
        y_inter = torch.einsum("bin,bhpn->bihp", ck, hs) \
            * torch.exp(cs)[..., None]
        decay = torch.exp(cs[:, -1:, :] - cs)                 # (B,Q,H)
        xw = xk.float() * (dtk * decay)[..., None]
        contrib = torch.einsum("bjhp,bjn->bhpn", xw, bk)
        hs = hs * torch.exp(cs[:, -1])[..., None, None] + contrib
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), hs


def _check(x, dt, a, b, c, h0, chunk):
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 3 or \
            c.dim() != 3:
        raise ValueError(f"ssd_scan takes x (B,S,H,P), dt (B,S,H), a (H,), "
                         f"b and c (B,S,N); got ranks {x.dim()}, {dt.dim()}, "
                         f"{a.dim()}, {b.dim()}, {c.dim()}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or \
            tuple(b.shape) != (bsz, s, n) or tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"ssd_scan shapes differ in B, S, H or N: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}")
    if h0 is not None and tuple(h0.shape) != (bsz, h, p, n):
        raise ValueError(f"ssd_scan h0 must be {(bsz, h, p, n)}, got "
                         f"{tuple(h0.shape)}")
    if not (x.dtype == b.dtype == c.dtype) or \
            x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_scan takes x, b and c as float32 or bfloat16 "
                        f"of one dtype, got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or \
            (h0 is not None and h0.dtype != torch.float32):
        raise TypeError("ssd_scan takes dt, a and h0 in float32")
    devices = {t.device for t in (x, dt, a, b, c, h0) if t is not None}
    if len(devices) != 1:
        raise ValueError("ssd_scan operands on different devices")
    if min(x.shape) < 1 or n < 1:
        raise ValueError(f"ssd_scan needs non-empty operands, got x "
                         f"{tuple(x.shape)}, N {n}")
    if chunk < 1:
        raise ValueError(f"ssd_scan chunk must be >= 1, got {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P), h_final (B,H,P,N)) of the SSD scan from state h0."""
    _check(x, dt, a, b, c, h0, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, a, b, c, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan has no route for device {x.device}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if q > MAX_CHUNK or smem_bytes(q, n) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan kernel takes chunk <= {MAX_CHUNK} with "
                         f"its (Q, N) tiles in {SMEM_LIMIT} bytes of shared "
                         f"memory; chunk {q}, N {n} need "
                         f"{smem_bytes(q, n)}")
    if any(t.stride(-1) != 1 for t in (x, dt, b, c)):
        raise ValueError("ssd_scan kernel needs x, dt, b and c contiguous "
                         "along their last axis")
    a = a.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    lib = _build.library()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    err = lib.repro_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), h0.data_ptr() if h0 is not None else None,
        y.data_ptr(), hf.data_ptr(), bsz, s, h, p, n, q,
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        _build.DTYPE_CODES[x.dtype], _build.stream_handle())
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, hf


ssd_scan.launches = 0
