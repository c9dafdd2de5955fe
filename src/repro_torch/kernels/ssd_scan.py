"""K4: the Mamba-2 SSD chunked scan of every SSM layer's prefill.

``ssd_scan(x, dt, a, b, c, h0)`` replaces the Pallas kernel
``repro/kernels/ssd_scan.py:ssd_scan`` with the CUDA C++ kernels in
``csrc/ssd_scan.cu`` (its header says what bounds them).  x is (B,S,H,P),
dt (B,S,H) fp32 after the softplus, a (H,) fp32 (negative), b and c
(B,S,N) in x's dtype, h0 (B,H,P,N) fp32 or None (zeros).  Returns y
(B,S,H,P) in x's dtype and the final state (B,H,P,N) in fp32; the D-skip
stays with the caller (``models/ssm.py``).  The scan runs in chunks of
``chunk`` positions, the last one ragged where ``chunk`` does not divide S
(the Pallas kernel asserts that it does).  x, b, c and dt may be strided
views with a contiguous last axis, as the layer's splits leave them.

CPU tensors take :func:`ssd_scan_ref`; CUDA tensors launch the kernel of
their route or raise.  :func:`route` picks the route before launch, from
the dtype, the shapes and what TMA can read: bf16 at P 64, N 64 or 128,
chunks of 128 or one chunk (every mamba2-130m call) runs the wgmma + TMA
kernel; everything else, fp32 included, the CUDA-core kernel (which raises
where one block's shared memory cannot hold a chunk: see
:func:`smem_bytes`).  ``ssd_scan.launches`` counts kernel launches,
``ssd_scan.launches_by_route`` the same by route.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

CHUNK = 128        # the reference's SSD_CHUNK and the Pallas default
MAX_CHUNK = 128    # the SIMT kernel's largest chunk (its thread count is 256)
STATE_ROWS = 16    # state rows (P) per SIMT block: csrc/ssd_scan.cu PT
SMEM_LIMIT = 232448
ROUTES = ("wgmma", "simt")
# the wgmma route (csrc/ssd_scan.cu, namespace ssd_tc): chunks of 128 rows,
# P one 64-column box, N in 64-column boxes, a ring of 2 chunks
WGMMA_CHUNK = 128
WGMMA_P = 64
WGMMA_N = (64, 128)
WGMMA_STAGES = 2


def route(dtype: torch.dtype, p: int, n: int, chunk: int, s: int,
          x_strides: Optional[Sequence[int]] = None,
          bc_strides: Iterable[Sequence[int]] = (),
          addresses: Iterable[int] = ()) -> str:
    """The kernel a CUDA call launches: "wgmma" for bf16 at P 64 and N 64
    or 128, in chunks of 128 or one chunk of S <= 128, with x's heads
    packed (``x_strides`` (B, S, H, P) with H's stride P) and every row
    and batch stride of x, b and c (``bc_strides``) and every base
    ``address`` as TMA reads them (16-byte multiples); else "simt"."""
    q = min(chunk, s)
    if dtype != torch.bfloat16 or p != WGMMA_P or n not in WGMMA_N:
        return "simt"
    if q != WGMMA_CHUNK and not (q == s < WGMMA_CHUNK):
        return "simt"
    views = [] if x_strides is None else [(*x_strides[:2], x_strides[3])]
    views += [tuple(st) for st in bc_strides]
    if x_strides is not None and x_strides[2] != p:
        return "simt"
    if any(st[2] != 1 or st[0] % 8 or st[1] % 8 for st in views):
        return "simt"
    if any(addr % 16 for addr in addresses):
        return "simt"
    return "wgmma"


def wgmma_smem_bytes(n: int) -> int:
    """Dynamic shared memory of one wgmma-route block at state width ``n``
    (``ssd_tc::smem_bytes``): the ring of C, B (n/64 boxes each) and x
    tiles of 128 rows, the hi and lo bf16 tiles of h, four (128,) fp32
    vectors, the barriers and 1024 bytes to align the swizzled tiles."""
    box = WGMMA_CHUNK * 64 * 2
    stage = (2 * (n // 64) + 1) * box
    return (WGMMA_STAGES * stage + 2 * (n // 64) * WGMMA_P * 64 * 2
            + 4 * WGMMA_CHUNK * 4 + 16 * WGMMA_STAGES + 1024)


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


def _launch(kind: str, x, dt, a, b, c, h0, q: int):
    """Launch the kernel of route ``kind`` at chunk ``q`` (checked operands
    on the card); returns (y, h_final)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    smem = wgmma_smem_bytes(n) if kind == "wgmma" else smem_bytes(q, n)
    if smem > SMEM_LIMIT or (kind == "simt" and q > MAX_CHUNK):
        raise ValueError(f"ssd_scan {kind} kernel takes its tiles in "
                         f"{SMEM_LIMIT} bytes of shared memory (SIMT: chunk "
                         f"<= {MAX_CHUNK}); chunk {q}, N {n} need {smem}")
    a = a.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    lib = _build.library()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    hf = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), hf.data_ptr(), bsz, s, h, p, n, q,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), b.stride(0), b.stride(1), c.stride(0),
            c.stride(1))
    if kind == "wgmma":
        err = lib.repro_ssd_scan_wgmma(*args, _build.stream_handle())
        why = lib.repro_refusal().decode() if err else ""
        if why:
            raise ValueError(f"ssd_scan refused (B={bsz}, S={s}, H={h}, "
                             f"P={p}, N={n}, chunk={q}): {why}")
    else:
        err = lib.repro_ssd_scan(*args, _build.DTYPE_CODES[x.dtype],
                                 _build.stream_handle())
    _build.check(err, "ssd_scan")
    return y, hf


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,H,P), h_final (B,H,P,N)) of the SSD scan from state h0."""
    _check(x, dt, a, b, c, h0, chunk)
    return _ssd_scan_op(x, dt, a, b, c, h0, chunk)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, h0: Optional[torch.Tensor],
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation: launch K4's route on the current stream."""
    if any(t.stride(-1) != 1 for t in (x, dt, b, c)):
        raise ValueError("ssd_scan kernel needs x, dt, b and c contiguous "
                         "along their last axis")
    s, p, n = x.shape[1], x.shape[3], b.shape[-1]
    kind = route(x.dtype, p, n, chunk, s, x.stride(),
                 (b.stride(), c.stride()),
                 (x.data_ptr(), b.data_ptr(), c.data_ptr()))
    y, hf = _launch(kind, x, dt, a, b, c, h0, min(chunk, s))
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[kind] += 1
    return y, hf


@_ssd_scan_op.register_kernel("cpu")
def _(x, dt, a, b, c, h0, chunk):
    y, hf = ssd_scan_ref(x, dt, a, b, c, h0, chunk=chunk)
    return y.contiguous(), hf.contiguous()


@_ssd_scan_op.register_fake
def _(x, dt, a, b, c, h0, chunk):
    bsz, _, h, p = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((bsz, h, p, b.shape[-1]), dtype=torch.float32))


ssd_scan.launches = 0
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
