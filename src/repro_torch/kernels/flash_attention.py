"""K1: flash attention for the causal prefill of every attention layer.

``flash_attention(q, k, v)`` replaces the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention`` with the CUDA C++
kernel in ``csrc/flash_attention.cu`` (its header says what bounds it).
Layout as in the reference: q (BH,Sq,D), k and v (BHk,Sk,D) with
BH % BHk == 0; query row ``bh`` reads K/V row ``bh // (BH // BHk)``, so a
(B,S,H,D) tensor laid out as (B*H,S,D) needs no K/V repeat.  Queries are
right-aligned against the keys, unless ``q_start`` gives their absolute
start on the device: an int32 tensor of one value, which a captured graph
may rewrite between replays (a warm prefix
admission's suffix over its slot's gathered block row; the kernel's
header says why its rows then equal a cold prefill's).  CPU tensors take
:func:`flash_attention_ref`; CUDA tensors launch the kernel of their route
or raise.  :func:`route` picks the route before launch, from the dtype and
the head dim alone: bf16 at head dim 128 or 256 (every served call) runs
the wgmma + TMA kernel, everything else the CUDA-core kernel.
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_route`` the same by route.

The operator has a gradient: :func:`flash_attention_bwd`, the
``repro_torch::flash_attention_bwd`` operator, whose CUDA kernels are in
``csrc/flash_attention_bwd.cu`` (its header gives the design and what
bounds each route) and whose CPU kernel is the closed form
:func:`flash_attention_bwd_ref`.  :func:`bwd_route` picks its route as
:func:`route` does the forward's: bf16 at head dim 128 or 256 (every
training call of the dense family) runs three wgmma + TMA passes on the
tensor cores ("bwd_wgmma"), everything else (fp32, the small head dims)
three passes on the CUDA cores ("bwd_simt").  A call launches its route's
three passes and counts once, in ``launches`` and under its route.
Training never passes ``q_start``: the gradient of a call that did raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import tma_error

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
BQ, BK = 16, 32    # SIMT route's query and key tile rows
SMEM_LIMIT = 232448
ROUTES = ("wgmma", "simt")
BWD_ROUTES = ("bwd_wgmma", "bwd_simt")
# the counters' keys: the forward's routes and the backward's
COUNTED = ROUTES + BWD_ROUTES
# the backward's CUDA-core tiles (csrc/flash_attention_bwd.cu, namespace
# fa_bwd) and its wgmma route's (namespace fa_bwd::tc: 64-row tiles, a
# ring of 2 stages; passes stats, dK/dV and dQ)
BWD_TILE = 32
BWD_WGMMA_PASSES = ("stats", "dkdv", "dq")
# the wgmma route (csrc/flash_attention.cu, namespace fa_tc): 64 query rows
# a block, K/V tiles of 64 keys in a ring of 2 stages
WGMMA_HEAD_DIMS = (128, 256)
WGMMA_TILE = 64
WGMMA_STAGES = 2


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches: "wgmma"
    for bf16 at head dim 128 or 256, else "simt" (CUDA cores)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The kernels a CUDA call of the backward launches: "bwd_wgmma" for
    bf16 at head dim 128 or 256, else "bwd_simt" (CUDA cores)."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "bwd_wgmma"
    return "bwd_simt"


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one SIMT-route block at head dim ``d``
    (csrc/flash_attention.cu ``launch_d``): the query tile, the key tile
    padded to d + 1 columns and the value tile, all fp32."""
    return 4 * (BQ * d + BK * (d + 1) + BK * d)


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one wgmma-route block at head dim ``d``
    (``fa_tc::smem_bytes``): the Q tile and the K and V rings in bf16, the
    barriers, and 1024 bytes to align the swizzled tiles."""
    tile = WGMMA_TILE * d * 2
    return (1 + 2 * WGMMA_STAGES) * tile + 8 * (1 + 3 * WGMMA_STAGES) + 1024


def bwd_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one block of the backward's dK/dV pass,
    its largest (``fa_bwd::dkdv_smem``): K, V, Q and dO tiles padded to
    d + 1 fp32 columns, the P and dS tiles (32 x 33) and two rows of
    per-query statistics."""
    t = BWD_TILE
    return 4 * (4 * t * (d + 1) + 2 * t * (t + 1) + 2 * t)


def bwd_wgmma_smem_bytes(d: int, kernel: str = "dkdv") -> int:
    """Dynamic shared memory of one block of the backward's wgmma pass
    ``kernel`` at head dim ``d`` (``fa_bwd::tc::{stats,dkdv,dq}_smem``;
    "dkdv", the default, is the largest): 64-row bf16 tiles (the stats
    pass: Q and 2 K stages; dK/dV: K, V and 2 stages of (Q, dO) with the
    64 rows' L and D in fp32; dQ: Q, dO and 2 stages of (K, V)), 8 bytes
    a barrier (1 + 2 a stage), and 1024 bytes to align the swizzled
    tiles."""
    if kernel not in BWD_WGMMA_PASSES:
        raise ValueError(f"kernel is one of {BWD_WGMMA_PASSES}, got "
                         f"{kernel!r}")
    tile = WGMMA_TILE * d * 2
    barriers = 8 * (1 + 2 * WGMMA_STAGES)
    if kernel == "stats":
        return (1 + WGMMA_STAGES) * tile + barriers + 1024
    stats = WGMMA_STAGES * 2 * WGMMA_TILE * 4 if kernel == "dkdv" else 0
    return (2 + 2 * WGMMA_STAGES) * tile + stats + barriers + 1024


def _check_start(q_start: torch.Tensor, q: torch.Tensor):
    if q_start.dtype != torch.int32 or q_start.numel() != 1:
        raise ValueError(f"q_start takes one int32 value: got "
                         f"{q_start.dtype}, {tuple(q_start.shape)}")
    if q_start.device != q.device:
        raise ValueError(f"q_start on {q_start.device}, q on {q.device}")


def _mask(sq: int, sk: int, causal: bool, window: int, start, device):
    """(Sq, Sk) bool: which keys each query sees, queries from ``start``."""
    q_pos = torch.arange(sq, device=device) + start
    k_pos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_start=None) -> torch.Tensor:
    """Plain version (``repro/kernels/ref.py:flash_attention``): repeat K/V
    over the query groups, fp32 scores, masked softmax, p cast to v's dtype
    before the p.v product.  ``q_start`` places the queries as
    ``attention.reference_attention``'s ``q_offset`` does."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    g = bh // bhk
    k = k.repeat_interleave(g, dim=0)
    v = v.repeat_interleave(g, dim=0)
    scores = torch.einsum("bqd,bkd->bqk", q, k).float() * d ** -0.5
    start = sk - sq if q_start is None else q_start.reshape(()).long()
    mask = _mask(sq, sk, causal, window, start, q.device)
    scores = torch.where(mask[None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (BH,Sq,D), k/v (BHk,Sk,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] != k.shape[2] or q.shape[0] % k.shape[0] != 0:
        raise ValueError(f"flash_attention: head_dim or GQA grouping differs: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention operands on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_start=None) -> torch.Tensor:
    _check(q, k, v)
    if q_start is not None:
        _check_start(q_start, q)
    return _flash_attention_op(q, k, v, causal, window, q_start)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int,
                        q_start: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA implementation: launch K1's route on the current stream."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    lib = _build.library()
    kind = route(q.dtype, d)
    start = None if q_start is None else q_start.data_ptr()
    if kind == "wgmma":
        # TMA reads from 16-byte aligned bases: copy a view that is not
        q, k, v = (t if tma_error(t.shape[1:], t.stride()[1:],
                                  t.element_size(), t.data_ptr()) is None
                   else t.clone() for t in (q, k, v))
        out = torch.empty_like(q)
        err = lib.repro_flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bhk, sq, sk, d, int(causal), int(window), start,
            _build.stream_handle())
        why = lib.repro_refusal().decode() if err else ""
        if why:
            raise ValueError(f"flash_attention refused (BH={bh}, Sq={sq}, "
                             f"Sk={sk}, D={d}): {why}")
    else:
        out = torch.empty_like(q)
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            bhk, sq, sk, d, int(causal), int(window), start,
            _build.DTYPE_CODES[q.dtype], _build.stream_handle())
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_route[kind] += 1
    return out


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, causal, window, q_start):
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_start=q_start).contiguous()


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_start):
    return q.new_empty(q.shape)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of K1's gradient, in closed form and fp32: P
    recomputed as the forward's masked softmax, then dV = P^T dO,
    dS = P * (dO V^T - rowsum(dO * O)), dQ = dS K * scale,
    dK = dS^T Q * scale, dK and dV summed over each KV head's G query
    heads.  Queries right-aligned against the keys.  Returns (dq, dk, dv)
    in the inputs' dtypes."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    g = bh // bhk
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    kr = kf.repeat_interleave(g, dim=0)
    vr = vf.repeat_interleave(g, dim=0)
    scale = d ** -0.5
    scores = torch.einsum("bqd,bkd->bqk", qf, kr) * scale
    mask = _mask(sq, sk, causal, window, sk - sq, q.device)
    scores = torch.where(mask[None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vr)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, kr) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dk = dk.reshape(bhk, g, sk, d).sum(1)
    dv = dv.reshape(bhk, g, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``out`` for the
    output gradient ``dout`` (shaped as q), through the
    ``repro_torch::flash_attention_bwd`` operator."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd takes out and dout shaped as "
                         f"q {tuple(q.shape)}, got {tuple(out.shape)} and "
                         f"{tuple(dout.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            out.device != q.device or dout.device != q.device:
        raise TypeError("flash_attention_bwd takes out and dout of q's dtype "
                        "and device")
    return _flash_attention_bwd_op(q, k, v, out, dout, causal, window)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, causal: bool, window: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The CUDA implementation: launch the three passes of the backward's
    route on the current stream."""
    bh, sq, d = q.shape
    bhk, sk, _ = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if sq > sk:
        raise ValueError(f"flash_attention_bwd kernel takes Sq <= Sk, got "
                         f"{sq} > {sk}")
    if not all(t.is_contiguous() for t in (q, k, v, out, dout)):
        raise ValueError("flash_attention_bwd kernel needs contiguous q, k, "
                         "v, out and dout")
    lib = _build.library()
    kind = bwd_route(q.dtype, d)
    if kind == "bwd_wgmma":
        # TMA reads from 16-byte aligned bases: copy a view that is not
        q, k, v, out, dout = (
            t if tma_error(t.shape[1:], t.stride()[1:], t.element_size(),
                           t.data_ptr()) is None else t.clone()
            for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bh, bhk, sq, sk, d,
            int(causal), int(window))
    if kind == "bwd_wgmma":
        err = lib.repro_flash_attention_bwd_wgmma(*ptrs,
                                                  _build.stream_handle())
        why = lib.repro_refusal().decode() if err else ""
        if why:
            raise ValueError(f"flash_attention_bwd refused (BH={bh}, "
                             f"BHk={bhk}, Sq={sq}, Sk={sk}, D={d}): {why}")
    else:
        err = lib.repro_flash_attention_bwd(
            *ptrs, _build.DTYPE_CODES[q.dtype], _build.stream_handle())
    _build.check(err, "flash_attention_bwd")
    flash_attention.launches += 1
    flash_attention.launches_by_route[kind] += 1
    return dq, dk, dv


@_flash_attention_bwd_op.register_kernel("cpu")
def _(q, k, v, out, dout, causal, window):
    return tuple(t.contiguous() for t in flash_attention_bwd_ref(
        q, k, v, out, dout, causal=causal, window=window))


@_flash_attention_bwd_op.register_fake
def _(q, k, v, out, dout, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, q_start = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.causal, ctx.window = causal, window
    ctx.has_start = q_start is not None


def _backward(ctx, dout):
    if ctx.has_start:
        raise NotImplementedError(
            "flash_attention's gradient takes right-aligned queries: a call "
            "with q_start (a warm prefix admission) has none")
    q, k, v, out = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                     causal=ctx.causal, window=ctx.window)
    return dq, dk, dv, None, None, None


_flash_attention_op.register_autograd(_backward,
                                      setup_context=_setup_context)

flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(COUNTED, 0)
