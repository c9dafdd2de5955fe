"""Attention (port of ``repro/models/attention.py``).

Layouts follow the reference: activations (B, S, H, D), caches
(B, C, Hkv, D), and the paged KV arena (P + 1, bs, Hkv, D) addressed
through a (B, M) block table (``gather_paged_kv``, ``write_paged_kv``,
``rollback_paged_kv``: plain PyTorch, as the reference computes them
outside any Pallas kernel).  Prefill attention runs through K1
(``kernels.ops.flash_attention``), which maps query heads to their KV head
by index, so K/V are never repeated on that path; so does a warm prefix
admission's suffix, over its slot's gathered block row with the queries
at a start on the device.  Decode attention (one
query per row against its cache slots) is plain PyTorch, as the reference
leaves it to XLA.
"""
from __future__ import annotations

from typing import NamedTuple

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


class PagedIndex(NamedTuple):
    """Where one decode step (or one warm admission's suffix) reads and
    writes a paged arena, the same for every attention layer (they share
    the block table, ``pos``, the block size and the sink), so a step
    computes it once.

    blocks: (B, M) physical block of each logical block (read-only shared
    entries decoded, unmapped ones at block 0); dest, off: shaped as the
    positions, (B,) or (B, S), the physical block and offset of each
    write, dest the sink where it drops."""
    blocks: torch.Tensor
    dest: torch.Tensor
    off: torch.Tensor


def _physical(block_table: torch.Tensor) -> torch.Tensor:
    phys = torch.where(block_table >= 0, block_table, -block_table - 2)
    return phys.clamp(min=0).long()


def _paged_dest(block_table, pos, bs: int, sink: int, keep=None):
    """Physical block of each position's write (``pos``: (B,) or (B, S)),
    or ``sink`` where the write drops: an unmapped (-1) or read-only
    shared (``-(p + 2)``) entry, a position past the table, or ``keep``
    (shaped as ``pos``) False.  Also returns the clamped table entries."""
    m = block_table.shape[1]
    blk = torch.div(pos, bs, rounding_mode="floor")
    idx = blk.clamp(0, m - 1).long()
    phys = (block_table.gather(1, idx[:, None])[:, 0] if pos.dim() == 1
            else block_table.gather(1, idx))
    writable = (phys >= 0) & (blk < m)
    if keep is not None:
        writable &= keep
    return torch.where(writable, phys, torch.full_like(phys, sink)).long(), \
        phys


def paged_index(block_table: torch.Tensor, pos: torch.Tensor, bs: int,
                sink: int, live=None) -> PagedIndex:
    """The :class:`PagedIndex` of a (B, M) block table at positions
    ``pos`` (B,) or (B, S), for arenas of ``bs``-token blocks whose sink
    is block ``sink``.  A row with ``live`` (shaped as ``pos``) False
    writes to the sink (the reference's ``writable &= live``)."""
    dest, _ = _paged_dest(block_table, pos, bs, sink, keep=live)
    return PagedIndex(_physical(block_table), dest,
                      torch.remainder(pos, bs).long())


def gather_paged(arena: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """The logical per-row cache (B, M*bs, H, D) of ``arena`` for the
    (B, M) physical ``blocks`` (:attr:`PagedIndex.blocks`)."""
    b, m = blocks.shape
    return arena[blocks].reshape(b, m * arena.shape[1], *arena.shape[2:])


def write_paged(arena: torch.Tensor, index: PagedIndex,
                val: torch.Tensor) -> torch.Tensor:
    """Values shaped as the index's positions plus (H, D) into
    ``arena[dest, off]``, in place: (B, H, D) for a decode step, (B, S, H,
    D) for a suffix."""
    arena[index.dest, index.off] = val.to(arena.dtype)
    return arena


def gather_paged_kv(arena: torch.Tensor,
                    block_table: torch.Tensor) -> torch.Tensor:
    """Block-table-indexed cache read (the paged-KV jump-table dereference).

    arena: (P + 1, bs, H, D) physical blocks, the last of them the sink
    (see :func:`write_paged_kv`); block_table: (B, M) physical block id per
    logical block, -1 = unmapped, ``-(p + 2)`` = physical block p mapped
    READ-ONLY (a cross-request shared prefix block: the write path keys
    its guard on ``phys >= 0``, so the encoding makes shared blocks
    unwritable while this gather decodes them back).  Returns the logical
    per-row cache (B, M*bs, H, D): logical block j of row b is
    ``arena[decode(block_table[b, j])]``.  Unmapped entries read block 0,
    as in the reference; callers mask them through the valid-length check
    of :func:`decode_attention`, whose masked products are exact zeros
    (``torch.where`` on the scores), so what they hold never reaches a
    result.  K1 over a gathered row (a warm admission's suffix) multiplies
    masked keys by p = 0 too, so it needs them finite, not only masked:
    every block of the arena is, since the engine boots it zeroed and
    every write into it (a program's K/V, a copy back from the host tier)
    is a finite K/V row.
    """
    return gather_paged(arena, _physical(block_table))


def write_paged_kv(arena: torch.Tensor, block_table: torch.Tensor,
                   pos: torch.Tensor, val: torch.Tensor,
                   live=None) -> torch.Tensor:
    """Block-table-indexed cache write of one token per row, in place.

    Row b's value (B, H, D) lands in physical block
    ``block_table[b, pos[b] // bs]`` at offset ``pos[b] % bs``.  Rows whose
    block is unmapped (released slots, table entry -1) drop, and so does
    any write aimed at a READ-ONLY shared-prefix mapping (``-(p + 2)``, see
    :func:`gather_paged_kv`), or at a position beyond the table
    (speculative overshoot past the reservation).

    ``live`` (B,) bool also drops the rows it marks False (a fused horizon
    holds a finished row still while the others keep stepping); ``None``
    means every row writes.

    The drop is a **sink block**: the arena holds one physical block more
    than the pager owns (index ``P``, the last), and every dropped row is
    written there.  The reference sends it out of range and lets the
    scatter's ``mode="drop"`` elide it; torch has none, filtering the rows
    by a mask would read the mask on the host (a sync a CUDA graph cannot
    hold), and clamping onto a real block would race with a real write to
    it.  The sink is never on the free list, never gathered for a valid
    position and never copied to the host, so what lands there (several
    dropped rows may race for one offset) is never read.
    """
    index = paged_index(block_table, pos, arena.shape[1], arena.shape[0] - 1,
                        live=live)
    return write_paged(arena, index, val)


def rollback_paged_kv(arena: torch.Tensor, orig: torch.Tensor,
                      block_table: torch.Tensor, pos_cand: torch.Tensor,
                      reject: torch.Tensor) -> torch.Tensor:
    """Undo rejected speculative writes in a paged arena, byte-exactly, in
    place.

    A verify step writes KV for every candidate position before knowing
    which drafts the target model accepts; rolling the arena back to the
    pre-verify bytes at the rejected positions makes the post-verify cache
    identical to having decoded only the accepted tokens one at a time.

    arena: (..., P + 1, bs, H, D) post-verify, the last block the sink
    (a group-stacked leaf carries its layers first); orig: same shape,
    pre-verify; pos_cand: (B, S) absolute position of each candidate
    write; reject: (B, S) bool, True where the write must be undone.
    Unmapped, read-only or out-of-table positions were dropped into the
    sink by :func:`write_paged_kv` and drop there again here.
    """
    bs = arena.shape[-3]
    dest, phys = _paged_dest(block_table, pos_cand, bs, arena.shape[-4] - 1,
                             keep=reject)
    off = torch.remainder(pos_cand, bs).long()
    vals = orig[..., phys.clamp(min=0).long(), off, :, :]  # (..., B, S, H, D)
    arena[..., dest, off, :, :] = vals
    return arena


# cache lengths that are multiples of this run the batch's rows in one call;
# others one row at a time (see decode_attention)
BATCHED_CACHE_MULTIPLE = 64


def _attend_one_query(q, k_cache, v_cache, valid):
    b, _, h, d = q.shape
    hk = k_cache.shape[2]
    qg = q.reshape(b, hk, h // hk, d)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float() * d ** -0.5
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, D); caches: (B, C, Hkv, D); cache_len: () or (B,) valid
    positions per row (a number, or a tensor on q's device: inside a CUDA
    graph it must be a tensor, since a copy from the host is what a capture
    refuses).  Grouped heads read their KV head through the einsum's group
    axis, with no repeat.  Rounding follows the reference: scores are taken
    in q's dtype and then fp32, p is cast to v's dtype before the p.v
    product.

    A row's bits do not depend on the batch.  cuBLAS picks the batched
    products' kernel by the batch count, and at a cache length off a
    multiple of :data:`BATCHED_CACHE_MULTIPLE` (seamless's 500 cross keys)
    a row of a batch-4 call differed on the H100 from the same row alone;
    such a cache is read one row at a time, each row the call a batch of
    one makes.  ``chip_smoke.py``'s phase 22 holds both forms' rows
    against the rows alone on the card.
    """
    b, c = q.shape[0], k_cache.shape[1]
    valid = _valid_cache_slots(cache_len, b, c, window=window, ring=ring,
                               device=q.device)
    if b == 1 or c % BATCHED_CACHE_MULTIPLE == 0:
        return _attend_one_query(q, k_cache, v_cache, valid)
    return torch.cat([_attend_one_query(q[i:i + 1], k_cache[i:i + 1],
                                        v_cache[i:i + 1], valid[i:i + 1])
                      for i in range(b)])


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_start=None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) -> (B, Sq, H, D) through K1,
    queries right-aligned against the keys, or from ``q_start`` (an int32
    device tensor of one start, as K1 takes it).

    Laid out as (B*H, Sq, D) and (B*Hkv, Sk, D): query row b*H + h reads
    KV row (b*H + h) // G = b*Hkv + h // G, the kernel's GQA map."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * hk, sk, d).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * hk, sk, d).contiguous()
    out = ops.flash_attention(qf, kf, vf, causal=causal, window=window,
                              q_start=q_start)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)


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
