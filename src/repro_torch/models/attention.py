"""Attention (port of ``repro/models/attention.py``).

Layouts follow the reference: activations (B, S, H, D), caches
(B, C, Hkv, D).  Prefill attention runs through K1
(``kernels.ops.flash_attention``), which maps query heads to their KV head
by index, so K/V are never repeated on that path.  Decode attention (one
query per row against its cache slots) is plain PyTorch, as the reference
leaves it to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating each kv head G times."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return k.repeat_interleave(n_heads // hkv, dim=2)


def _valid_cache_slots(cache_len, b: int, c: int, *, window: int,
                       ring: bool, device=None) -> torch.Tensor:
    """(B, C) bool mask of readable cache slots.  ``cache_len`` is a scalar
    or a (B,) vector of per-slot lengths.  A ring buffer (size C == window)
    holds every slot < min(len, C); a flat buffer holds slots < len, and
    with a window only the last ``window`` of them."""
    cl = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    cl = cl.expand(b).reshape(b, 1) if cl.dim() == 0 else cl.reshape(b, 1)
    slot = torch.arange(c, device=cl.device)[None, :]
    if ring:
        return slot < torch.clamp(cl, max=c)
    valid = slot < cl
    if window > 0:
        valid &= slot >= cl - window
    return valid


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, D); caches: (B, C, Hkv, D); cache_len: () or (B,) valid
    positions per row.  Grouped heads read their KV head through the
    einsum's group axis, with no repeat.  Rounding follows the reference:
    scores are taken in q's dtype and then fp32, p is cast to v's dtype
    before the p.v product.
    """
    b, _, h, d = q.shape
    c, hk = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hk, h // hk, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * d ** -0.5
    valid = _valid_cache_slots(cache_len, b, c, window=window, ring=ring,
                               device=q.device)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D), k/v: (B, S, Hkv, D) -> (B, S, H, D) through K1.

    Laid out as (B*H, S, D) and (B*Hkv, S, D): query row b*H + h reads KV
    row (b*H + h) // G = b*Hkv + h // G, the kernel's GQA map."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * hk, s, d).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * hk, s, d).contiguous()
    out = ops.flash_attention(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def reference_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """O(S^2)-memory oracle used by tests.  q: (B,Sq,H,D), k/v: (B,Sk,Hkv,D)."""
    b, sq, h, d = q.shape
    k = repeat_kv(k, h)
    v = repeat_kv(v, h)
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
