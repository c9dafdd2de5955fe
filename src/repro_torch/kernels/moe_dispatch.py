"""K3: the grouped expert FFN of every MoE layer.

``moe_ffn(buf, w1, w3, w2)`` replaces the Pallas kernel
``repro/kernels/moe_dispatch.py:moe_ffn`` with the CUDA C++ kernel in
``csrc/moe_ffn.cu`` (its header says what bounds it and how it keeps each
token's result independent of the batch).  buf is (E, C, d), w1 and w3 are
(E, d, f), w2 is (E, f, d); the result is (E, C, d) in buf's dtype.
``counts`` (optional, (E,) int32) gives each expert's live rows: rows at
or past ``counts[e]`` come out as zeros and the kernel reads no weights
for an expert without rows.  CPU tensors take :func:`moe_ffn_ref`; CUDA
tensors launch the kernel of their route or raise.  :func:`route` picks
the route before launch: bf16 with d and f multiples of 64 and operands
TMA can read (every olmoe-1b-7b and qwen3-moe-30b-a3b call) runs the
wgmma + TMA kernels, two launches over an (E, C, f) bf16 scratch for the
hidden; everything else the CUDA-core kernel (which raises where one
block's shared memory cannot hold the hidden: (32 + f) x 16 rows of fp32
must fit in 227 KB, so f <= 3,600).  ``moe_ffn.launches`` counts calls
that launched (one per call, whatever the route),
``moe_ffn.launches_by_route`` the same by route.

The operator has a gradient: :func:`moe_ffn_bwd`, the
``repro_torch::moe_ffn_bwd`` operator, whose CUDA kernels are in
``csrc/moe_ffn_bwd.cu`` (its header gives the design and what bounds it)
and whose CPU kernel is :func:`moe_ffn_bwd_ref`.  It recomputes the hidden
from the forward's inputs (nothing else is saved) and runs three passes,
no atomics, on the route :func:`bwd_route` picks before launch: bf16 with
d and f multiples of 64 and weights TMA can read (every olmoe-1b-7b and
qwen3-moe-30b-a3b training call) on the tensor cores, wgmma fed by TMA
("bwd_wgmma"); everything else on the CUDA cores in fp32 ("bwd_simt").  A
call counts once, in ``launches`` and under its route.  ``counts`` takes
no gradient.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import tma_error

ROUTES = ("wgmma", "simt")
BWD_ROUTES = ("bwd_wgmma", "bwd_simt")
# the counters' keys: the forward's routes and the backward's
COUNTED = ROUTES + BWD_ROUTES
# the wgmma route (csrc/moe_ffn.cu, namespace moe_tc): 64 weight columns
# and 64 of k a slab; token rows a block from TILE_ROWS; a ring of 4
# (gate/up, two weight slabs a stage) or 6 (down) stages; epilogue staging
# rows of 72 bf16
TILE = 64
TILE_ROWS = (8, 16, 32, 48, 64)
STAGES = {"gate_up": 4, "down": 6}
STAGING_ROW = TILE + 8
# the backward's wgmma route (csrc/moe_ffn_bwd.cu, namespace moe_bwd::tc):
# its three passes, a ring of 3 stages each
BWD_WGMMA_PASSES = ("hidden", "dx", "dw")
BWD_STAGES = 3


def tile_rows(c: int) -> int:
    """Token rows of one wgmma-route block (the instruction's n) for a
    buffer of C rows: the least of 8, 16, 32, 48 that holds C, else 64
    (row tiles of 64).  A function of C alone, so a token's bits do not
    depend on how many others share its expert."""
    return next((n for n in TILE_ROWS if c <= n), TILE_ROWS[-1])


def route(dtype: torch.dtype, d: int, f: int,
          addresses: Sequence[int] = ()) -> str:
    """The kernel a CUDA call launches: "wgmma" for bf16 with d and f
    multiples of 64 (whole weight tiles, so every row stride is a multiple
    of 16 bytes) and weight ``addresses`` TMA can read
    (``matmul.tma_error``: 16-byte aligned), else "simt" (CUDA cores)."""
    if dtype != torch.bfloat16 or d % TILE or f % TILE:
        return "simt"
    if any(tma_error((d, f), (f, 1), 2, a) for a in addresses):
        return "simt"
    return "wgmma"


def bwd_route(dtype: torch.dtype, d: int, f: int,
              addresses: Sequence[int] = ()) -> str:
    """The kernels a CUDA call of the backward launches: "bwd_wgmma" for
    bf16 with d and f multiples of 64 and weight ``addresses`` TMA can read
    (``matmul.tma_error``: 16-byte aligned), as :func:`route`, else
    "bwd_simt" (CUDA cores)."""
    if route(dtype, d, f, addresses) == "wgmma":
        return "bwd_wgmma"
    return "bwd_simt"


def bwd_wgmma_smem_bytes(kernel: str) -> int:
    """Dynamic shared memory of one block of the backward's wgmma pass
    ``kernel`` (``moe_bwd::tc::smem_bytes``): a ring of BWD_STAGES stages
    of 64 x 64 bf16 boxes (8 KB), seven a stage in "hidden" (the W1, W3
    and W2 slabs and 128 rows of X and dY) and eight in "dx" (128 rows of
    W1, W3, dG and dU) and "dw" (64 rows of X and dY, and of H, dG and dU
    at 128 hidden columns), 16 bytes of barriers a stage, and 1024 bytes to
    align the swizzled ring.  The epilogues reuse the ring."""
    if kernel not in BWD_WGMMA_PASSES:
        raise ValueError(f"kernel is one of {BWD_WGMMA_PASSES}, got "
                         f"{kernel!r}")
    boxes = 7 if kernel == "hidden" else 8
    return BWD_STAGES * boxes * TILE * TILE * 2 + 16 * BWD_STAGES + 1024


def wgmma_smem_bytes(gate_up: bool, nt: int) -> int:
    """Dynamic shared memory of one wgmma-route block
    (``moe_tc::smem_bytes``): the ring of weight slabs and token rows, the
    epilogue's bf16 staging tile, the barriers and 1024 bytes to align the
    swizzled ring."""
    stages = STAGES["gate_up" if gate_up else "down"]
    stage = (2 if gate_up else 1) * TILE * TILE * 2 + nt * TILE * 2
    return stages * stage + nt * STAGING_ROW * 2 + 16 * stages + 1024


def moe_ffn_ref(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor,
                counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version with the Pallas kernel's numerics
    (``repro/kernels/moe_dispatch.py:_kernel``): fp32 products, silu and
    gating in fp32, the hidden cast to buf's dtype before the w2 product,
    which accumulates in fp32 again."""
    x = buf.float()
    g = torch.matmul(x, w1.float())
    u = torch.matmul(x, w3.float())
    h = (F.silu(g) * u).to(buf.dtype)
    out = torch.matmul(h.float(), w2.float()).to(buf.dtype)
    if counts is not None:
        rows = torch.arange(buf.shape[1], device=buf.device)
        live = rows[None, :] < counts.to(buf.device)[:, None]
        out = torch.where(live[..., None], out, torch.zeros_like(out))
    return out


def _check(buf, w1, w3, w2, counts):
    if buf.dim() != 3 or w1.dim() != 3 or w3.dim() != 3 or w2.dim() != 3:
        raise ValueError(f"moe_ffn takes buf (E,C,d), w1/w3 (E,d,f) and w2 "
                         f"(E,f,d); got ranks {buf.dim()}, {w1.dim()}, "
                         f"{w3.dim()}, {w2.dim()}")
    e, _, d = buf.shape
    f = w1.shape[2]
    if tuple(w1.shape) != (e, d, f) or tuple(w3.shape) != (e, d, f) or \
            tuple(w2.shape) != (e, f, d):
        raise ValueError(f"moe_ffn shapes differ in E, d or f: buf "
                         f"{tuple(buf.shape)}, w1 {tuple(w1.shape)}, w3 "
                         f"{tuple(w3.shape)}, w2 {tuple(w2.shape)}")
    if not (buf.dtype == w1.dtype == w3.dtype == w2.dtype) or \
            buf.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"moe_ffn takes float32 or bfloat16 operands of one "
                        f"dtype, got {buf.dtype}, {w1.dtype}, {w3.dtype}, "
                        f"{w2.dtype}")
    if not (buf.device == w1.device == w3.device == w2.device):
        raise ValueError("moe_ffn operands on different devices")
    if not all(t.is_contiguous() for t in (buf, w1, w3, w2)):
        raise ValueError("moe_ffn needs contiguous buf, w1, w3 and w2")
    if counts is not None and (counts.shape != (e,) or
                               counts.dtype != torch.int32 or
                               counts.device != buf.device):
        raise ValueError(f"moe_ffn counts must be ({e},) int32 on "
                         f"{buf.device}, got {tuple(counts.shape)} "
                         f"{counts.dtype} on {counts.device}")


def moe_ffn(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor,
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E,C,d) routed token rows -> (E,C,d) expert SwiGLU outputs."""
    _check(buf, w1, w3, w2, counts)
    return _moe_ffn_op(buf, w1, w3, w2, counts)


@torch.library.custom_op("repro_torch::moe_ffn", mutates_args=(),
                         device_types="cuda")
def _moe_ffn_op(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor,
                counts: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA implementation: launch K3's route on the current stream."""
    e, c, d = buf.shape
    f = w1.shape[2]
    lib = _build.library()
    kind = route(buf.dtype, d, f, [t.data_ptr() for t in (w1, w3, w2)])
    if kind == "wgmma" and tma_error((c, d), (d, 1), 2, buf.data_ptr()):
        buf = buf.clone()       # small, unlike the weights: copy to align
    out = torch.empty_like(buf)
    n_ptr = counts.data_ptr() if counts is not None else None
    if kind == "wgmma":
        nt = tile_rows(c)
        h = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
        err = lib.repro_moe_ffn_wgmma(
            buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            n_ptr, h.data_ptr(), out.data_ptr(), e, c, d, f, nt,
            _build.stream_handle())
        why = lib.repro_refusal().decode() if err else ""
        if why:
            raise ValueError(f"moe_ffn refused (E={e}, C={c}, d={d}, f={f}): "
                             f"{why}")
    else:
        err = lib.repro_moe_ffn(
            buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            n_ptr, out.data_ptr(), e, c, d, f, _build.DTYPE_CODES[buf.dtype],
            _build.stream_handle())
    _build.check(err, "moe_ffn")
    moe_ffn.launches += 1
    moe_ffn.launches_by_route[kind] += 1
    return out


@_moe_ffn_op.register_kernel("cpu")
def _(buf, w1, w3, w2, counts):
    return moe_ffn_ref(buf, w1, w3, w2, counts).contiguous()


@_moe_ffn_op.register_fake
def _(buf, w1, w3, w2, counts):
    return buf.new_empty(buf.shape)


def _live(counts: Optional[torch.Tensor], e: int, c: int, device):
    """(E, C, 1) bool: the rows below each expert's count (all of them
    without counts)."""
    if counts is None:
        return torch.ones((e, c, 1), dtype=torch.bool, device=device)
    rows = torch.arange(c, device=device)
    return (rows[None, :] < counts.to(device)[:, None])[..., None]


def moe_ffn_bwd_ref(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor, dy: torch.Tensor,
                    counts: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Plain version of K3's gradient, with the kernel's rounding points:
    G = X W1, U = X W3 and dH = dY W2^T as fp32 products of the operands;
    H = silu(G) U, dG = dH U s (1 + G (1 - s)) (s = sigmoid(G)) and
    dU = dH silu(G) computed in fp32 and rounded to buf's dtype; then
    dX = dG W1^T + dU W3^T, dW1 = X^T dG, dW3 = X^T dU and dW2 = H^T dY as
    fp32 products of those rounded values, each rounded to the dtype once.
    Rows at or past ``counts[e]`` carry no gradient: their dX is zero and
    they add nothing to the weight gradients.  Returns (dbuf, dw1, dw3,
    dw2)."""
    dt = buf.dtype
    e, c, _ = buf.shape
    live = _live(counts, e, c, buf.device)
    x = torch.where(live, buf.float(), 0.0)
    dyf = torch.where(live, dy.float(), 0.0)
    w1f, w3f, w2f = w1.float(), w3.float(), w2.float()
    g, u = torch.matmul(x, w1f), torch.matmul(x, w3f)
    dh = torch.matmul(dyf, w2f.transpose(1, 2))
    s = torch.sigmoid(g)
    silu = g * s
    h = (silu * u).to(dt).float()
    dg = (dh * u * (s * (1 + g * (1 - s)))).to(dt).float()
    du = (dh * silu).to(dt).float()
    dx = torch.matmul(dg, w1f.transpose(1, 2)) + \
        torch.matmul(du, w3f.transpose(1, 2))
    dx = torch.where(live, dx, 0.0)
    dw1 = torch.matmul(x.transpose(1, 2), dg)
    dw3 = torch.matmul(x.transpose(1, 2), du)
    dw2 = torch.matmul(h.transpose(1, 2), dyf)
    return dx.to(dt), dw1.to(dt), dw3.to(dt), dw2.to(dt)


def moe_ffn_bwd(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor, dy: torch.Tensor,
                counts: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(dbuf, dw1, dw3, dw2) of ``moe_ffn(buf, w1, w3, w2, counts)`` for
    the output gradient ``dy`` (shaped as buf), through the
    ``repro_torch::moe_ffn_bwd`` operator."""
    _check(buf, w1, w3, w2, counts)
    if dy.shape != buf.shape or dy.dtype != buf.dtype or \
            dy.device != buf.device or not dy.is_contiguous():
        raise ValueError(f"moe_ffn_bwd takes a contiguous dy of buf's shape "
                         f"{tuple(buf.shape)}, dtype and device; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    return _moe_ffn_bwd_op(buf, w1, w3, w2, dy, counts)


@torch.library.custom_op("repro_torch::moe_ffn_bwd", mutates_args=(),
                         device_types="cuda")
def _moe_ffn_bwd_op(buf: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                    w2: torch.Tensor, dy: torch.Tensor,
                    counts: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The CUDA implementation: launch the backward's three passes on the
    current stream, over (E, C, f) scratch for H, dG and dU."""
    e, c, d = buf.shape
    f = w1.shape[2]
    lib = _build.library()
    kind = bwd_route(buf.dtype, d, f, [t.data_ptr() for t in (w1, w3, w2)])
    if kind == "bwd_wgmma":
        # small beside the weights: copy to align
        if tma_error((c, d), (d, 1), 2, buf.data_ptr()):
            buf = buf.clone()
        if tma_error((c, d), (d, 1), 2, dy.data_ptr()):
            dy = dy.clone()
    h, dg, du = (torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
                 for _ in range(3))
    dx, dw1, dw3, dw2 = (torch.empty_like(t) for t in (buf, w1, w3, w2))
    args = (buf.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
            counts.data_ptr() if counts is not None else None, dy.data_ptr(),
            h.data_ptr(), dg.data_ptr(), du.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), dw3.data_ptr(), dw2.data_ptr(), e, c, d, f)
    if kind == "bwd_wgmma":
        err = lib.repro_moe_ffn_bwd_wgmma(*args, _build.stream_handle())
        why = lib.repro_refusal().decode() if err else ""
        if why:
            raise ValueError(f"moe_ffn_bwd refused (E={e}, C={c}, d={d}, "
                             f"f={f}): {why}")
    else:
        err = lib.repro_moe_ffn_bwd(*args, _build.DTYPE_CODES[buf.dtype],
                                    _build.stream_handle())
    _build.check(err, "moe_ffn_bwd")
    moe_ffn.launches += 1
    moe_ffn.launches_by_route[kind] += 1
    return dx, dw1, dw3, dw2


@_moe_ffn_bwd_op.register_kernel("cpu")
def _(buf, w1, w3, w2, dy, counts):
    return tuple(t.contiguous() for t in moe_ffn_bwd_ref(buf, w1, w3, w2, dy,
                                                         counts))


@_moe_ffn_bwd_op.register_fake
def _(buf, w1, w3, w2, dy, counts):
    return tuple(t.new_empty(t.shape) for t in (buf, w1, w3, w2))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    buf, w1, w3, w2, counts = ctx.saved_tensors
    return (*moe_ffn_bwd(buf, w1, w3, w2, dy.contiguous(), counts), None)


_moe_ffn_op.register_autograd(_backward, setup_context=_setup_context)

moe_ffn.launches = 0
moe_ffn.launches_by_route = dict.fromkeys(COUNTED, 0)
