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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul import tma_error

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
BQ, BK = 16, 32    # SIMT route's query and key tile rows
SMEM_LIMIT = 232448
ROUTES = ("wgmma", "simt")
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


def _check_start(q_start: torch.Tensor, q: torch.Tensor):
    if q_start.dtype != torch.int32 or q_start.numel() != 1:
        raise ValueError(f"q_start takes one int32 value: got "
                         f"{q_start.dtype}, {tuple(q_start.shape)}")
    if q_start.device != q.device:
        raise ValueError(f"q_start on {q_start.device}, q on {q.device}")


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
    q_pos = torch.arange(sq, device=q.device) + start
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
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


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
