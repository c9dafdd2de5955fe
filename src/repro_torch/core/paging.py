"""paging — paged KV-cache arena over the dynamic-call table (paper §3.4),
port of ``repro/core/paging.py`` (its private-block half; the prefix trie,
``PrefixStore`` and ``publish`` come with ROADMAP Queue 1 item 7).

The serving engine's scale limit without this module is device memory:
every slot's full KV cache has to be resident, so concurrency x context
length is capped by the card.  The paper's answer to the same local-store
pressure is ``__dynamic_call`` paging: code lives in abundant global
memory and is copied into a small local arena on demand through a jump
table.  Here the *data* instantiation of that mechanism manages KV state:

  * each request's KV cache is a set of fixed-size **blocks** (``kv_block``
    tokens per block, per attention layer);
  * the device holds a capacity-bounded **arena** of physical blocks
    (usrcore tier) inside the cache tree, addressed through a per-slot
    **block table** carried next to ``pos``; one more block, the last, is
    the sink that dropped writes land in (``attention.write_paged_kv``),
    which this manager never hands out, copies or counts;
  * a request's blocks are one page in a :class:`DynamicCallTable` — LRU
    with pinning (active decode slots are pinned), eviction writes the
    victim's blocks back to the host tier (usrmem: CPU tensors, pinned
    when the arena is on the card, bound in the UVA registry when one is
    given so host code can read a swapped-out sequence's KV by name);
  * a **resume** of a preempted request is ``table.call``: a hit re-maps
    the still-resident physical blocks for free, a miss is a *page fault*
    that copies the blocks back from host memory.

Every host<->device move happens between program executions (the paper's
hot-load invariant: user segments mutate only while execution is held in
system code).  Unlike the reference, whose edits return a new tree, every
edit here is made in place on the live tensors (``copy_``,
``index_copy_``, ``fill_``), because the serving programs are CUDA graphs
bound to that storage; the methods still return the tree, so call sites
read as the reference's.  The copies are synchronous on the current
stream, the one the graphs replay on: a swap-out has its bytes on the
host before its blocks return to the free list, and a page fault's blocks
are in the arena, in stream order, before the next replay reads them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dynamic_calls import DCEntry, DynamicCallTable
from repro_torch.core.placement import USRCORE, USRMEM

Path = Tuple[str, ...]


def leaf_kind(path: Path) -> str:
    """Classify a cache-tree leaf: 'kv' (block arena), 'state' (per-slot
    recurrent row), or 'meta' (pos / block_table)."""
    if path[0] in ("pos", "block_table"):
        return "meta"
    return "kv" if path[-1] in ("k", "v") else "state"


def leaf_axis(path: Path) -> int:
    """Index axis of a cache leaf: group-stacked leaves carry a leading
    (layers,) axis, so the arena/slot axis is 1; tail leaves use axis 0."""
    return 1 if path[0] == "groups" else 0


def cache_leaves(caches,
                 prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """(key path, leaf) of the cache tree, keys in sorted order (the
    reference's tree order)."""
    if isinstance(caches, dict):
        return [item for k in sorted(caches)
                for item in cache_leaves(caches[k], prefix + (k,))]
    return [(prefix, caches)]


def encode_shared(phys: int) -> int:
    """Block-table encoding of a write-protected (shared) mapping.

    -1 stays "unmapped"; a shared block maps as ``-(phys + 2)`` — negative,
    so the device write guard (``phys >= 0``) drops any write aimed at it,
    while :func:`decode_block_table` (and its in-graph twin in
    ``repro_torch.models.attention.gather_paged_kv``) recovers the
    physical id for reads.
    """
    assert phys >= 0, phys
    return -(phys + 2)


def decode_block_table(row) -> torch.Tensor:
    """Host-side inverse of :func:`encode_shared`: physical ids with -1 for
    unmapped entries (shared or private status erased)."""
    row = torch.as_tensor(row)
    return torch.where(row >= 0, row, -row - 2)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` (pinned for a card tensor), made before the
    call returns."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


@dataclass
class _Page:
    """One request's KV footprint: its private blocks, resident (phys
    mapped into the arena) or swapped out (host copies of blocks +
    recurrent rows)."""
    rid: int
    n_blocks: int                           # logical blocks
    base_blocks: int = 0                    # admission-time reservation
    phys: Optional[List[int]] = None        # resident block ids
    host_blocks: Optional[List[torch.Tensor]] = None  # swapped-out KV
    state_rows: Optional[List[torch.Tensor]] = None   # rows at preempt


def _no_prefix(shared):
    if shared:
        raise NotImplementedError(
            "shared prefix blocks belong to prefix sharing, which is not "
            "ported yet (ROADMAP Queue 1 item 7)")


class PagedKVManager:
    """Host-side paging authority for one serving engine's KV arena.

    Residency policy (LRU, pinning, byte capacity) is delegated to a
    :class:`DynamicCallTable`; this class owns the physical-block free
    list, the host (usrmem) tier and the cache-tree edits that map and
    unmap block-table rows.  All methods that move data take the live
    cache tree, edit it in place and return it — they may only be called
    between program executions.

    ``on_fault(blocks)`` is called once per page fault with the blocks it
    copied back.  ``prefix_store`` belongs to prefix sharing (ROADMAP
    Queue 1 item 7) and raises.
    """

    def __init__(self, arena_blocks: int, block_bytes: int, *,
                 uva=None, on_fault: Optional[Callable[[int], None]] = None,
                 prefix_store=None):
        if prefix_store is not None:
            raise NotImplementedError(
                "prefix_store belongs to prefix sharing, which is not "
                "ported yet (ROADMAP Queue 1 item 7)")
        self.arena_blocks = int(arena_blocks)
        # floor of 1 byte/block keeps the byte accounting congruent with the
        # free list even for attention-free families (0 KV bytes per block)
        self.block_bytes = max(1, int(block_bytes))
        self.table = DynamicCallTable(self.arena_blocks * self.block_bytes,
                                      on_evict=self._on_evict)
        self.free: List[int] = list(range(self.arena_blocks - 1, -1, -1))
        self.pages: Dict[int, _Page] = {}
        self.uva = uva
        self.on_fault = on_fault
        self.page_faults = 0      # swap-ins that copied blocks from host
        self.swap_outs = 0        # LRU writebacks to the host tier
        self.hits = 0             # table calls served by resident pages
        self.loads = 0            # table calls that ran the loader
        self.grown_blocks = 0     # speculative over-allocations (grow)
        self.reclaimed_blocks = 0  # speculative reclaims (trim_to_base)
        self.swap_out_s = 0.0     # host seconds spent in swap-outs
        self.page_fault_s = 0.0   # host seconds spent in page faults
        self._caches = None       # staged tree during table ops

    # -- capacity ------------------------------------------------------------
    def _name(self, rid: int) -> str:
        return f"kv:{rid}"

    def can_admit(self, rid: int, n_blocks: int, shared=None) -> bool:
        """True when the blocks ``rid`` needs can be made resident without
        touching a pinned (actively mapped) page.  For a KNOWN rid (a
        preempted request about to resume) its private blocks may still be
        resident (a free resume); those must not double as eviction
        victims."""
        _no_prefix(shared)
        page = self.pages.get(rid)
        n = page.n_blocks if page is not None else int(n_blocks)
        own_resident = self.table.is_resident(self._name(rid))
        need = 0 if own_resident else n * self.block_bytes
        if need == 0:
            return True
        if need > self.table.capacity:
            return False
        free = self.table.capacity - self.table.resident_bytes
        return need <= free + self.table.evictable_bytes

    def arena_occupancy(self) -> float:
        used = self.arena_blocks - len(self.free)
        return used / max(self.arena_blocks, 1)

    # -- admission / release --------------------------------------------------
    def admit(self, rid: int, n_blocks: int, slot: int, caches, shared=None):
        """Reserve and map a new request's blocks; returns the tree with
        the slot's block-table row written.  May evict (write back) idle
        pages to make room."""
        _no_prefix(shared)
        assert rid not in self.pages, rid
        page = _Page(rid=rid, n_blocks=int(n_blocks),
                     base_blocks=int(n_blocks))
        self.pages[rid] = page
        name = self._name(rid)
        self.table.register(name, self._loader(rid),
                            page.n_blocks * self.block_bytes)
        caches = self._call_page(name, caches)
        return self._write_row(caches, slot, page)

    def release(self, rid: int, slot: int, caches):
        """Request finished: free its private blocks and unmap its row.

        Safe for a request that finishes while PREEMPTED (slot == -1, page
        unpinned, private blocks possibly already written back to the host
        tier): evicted pages have no resident blocks to free (no double
        free), their ``kvpage:`` host-tier entries are dropped exactly
        once, and no block-table row is touched (the slot was already
        cleared at preemption — and ``-1`` must never index a live row)."""
        page = self.pages.pop(rid)
        if self.table.is_resident(self._name(rid)) and page.phys is not None:
            self.free.extend(page.phys)
        self.table.remove(self._name(rid))
        self._drop_host(page)
        if slot < 0:
            return caches           # finished while preempted: no row to clear
        return self._clear_row(caches, slot)

    def grow(self, rid: int, n_total: int, slot: int, caches):
        """Speculative block over-allocation: best-effort extend a resident
        page's mapping toward ``n_total`` blocks from the FREE list only (never by evicting another page — a failed grow
        just means overshoot writes drop, which verify rollback
        tolerates)."""
        page = self.pages[rid]
        assert page.phys is not None, f"grow of non-resident page {rid}"
        extra = min(int(n_total) - page.n_blocks, len(self.free))
        if extra <= 0:
            return caches
        page.phys.extend(self.free.pop() for _ in range(extra))
        page.n_blocks += extra
        self.grown_blocks += extra
        self.table.resize(self._name(rid), page.n_blocks * self.block_bytes)
        return self._write_row(caches, slot, page)

    def trim_to_base(self, rid: int, slot: int, caches):
        """Reclaim on rejection: shrink a grown page back to its
        admission-time reservation, returning the speculative tail blocks
        to the free list and unmapping them from the slot's row.
        The verify program restored the freed blocks' bytes before this
        runs, so they are bit-identical to never having been written."""
        page = self.pages[rid]
        extra = page.n_blocks - page.base_blocks
        if extra <= 0 or page.phys is None:
            return caches
        self.free.extend(page.phys[page.base_blocks:])
        del page.phys[page.base_blocks:]
        page.n_blocks = page.base_blocks
        self.reclaimed_blocks += extra
        self.table.resize(self._name(rid), page.n_blocks * self.block_bytes)
        return self._write_row(caches, slot, page)

    def reset(self, caches):
        """The paper's DC-table reset applied to the KV arena: every
        non-pinned (preempted) page writes back to the host tier and frees
        its blocks; active (pinned) pages stay resident.  Lossless — a
        later resume page-faults the blocks back in.  (Always reset
        through this method, not ``table.reset()`` directly: the writeback
        hook needs the cache tree staged.)"""
        self._caches = caches
        self.table.reset()
        caches, self._caches = self._caches, None
        return caches

    # -- preemption / resume --------------------------------------------------
    def preempt(self, rid: int, slot: int, caches):
        """Swap a request out of its slot: the per-slot recurrent rows are
        copied to host eagerly (the slot is reused immediately); the
        private KV blocks stay resident — unpinned — until LRU pressure
        writes them back (lazy swap-out, so a quick resume is free)."""
        page = self.pages[rid]
        page.state_rows = [_to_host(leaf.select(leaf_axis(path), slot))
                           for path, leaf in cache_leaves(caches)
                           if leaf_kind(path) == "state"]
        self.table.unpin(self._name(rid))
        return self._clear_row(caches, slot)

    def resume(self, rid: int, slot: int, caches):
        """Swap a preempted request back in.  A still-resident page is a
        table hit (re-map only); an evicted one is a page fault that
        copies every private block back from the host tier.  The state
        rows are copied back into the slot."""
        page = self.pages[rid]
        caches = self._call_page(self._name(rid), caches)
        caches = self._write_row(caches, slot, page)
        rows = iter(page.state_rows)
        for path, leaf in cache_leaves(caches):
            if leaf_kind(path) == "state":
                leaf.select(leaf_axis(path), slot).copy_(next(rows))
        page.state_rows = None
        return caches

    def _call_page(self, name: str, caches):
        """``table.call`` with the cache tree staged for the loader/evictor
        (they run inside the call and edit it); counts hit vs load."""
        if self.table.is_resident(name):
            self.hits += 1
        else:
            self.loads += 1
        self._caches = caches
        self.table.call(name)
        self.table.pin(name)
        caches, self._caches = self._caches, None
        return caches

    # -- block-table rows -----------------------------------------------------
    def _write_row(self, caches, slot: int, page: _Page):
        bt = caches["block_table"]
        row = torch.full((bt.shape[1],), -1, dtype=torch.int32)
        row[:page.n_blocks] = torch.tensor(page.phys, dtype=torch.int32)
        bt[slot].copy_(row)
        return caches

    def _clear_row(self, caches, slot: int):
        caches["block_table"][slot].fill_(-1)
        return caches

    # -- the DC loader / evictor (host<->device block moves) ------------------
    def _loader(self, rid: int):
        def load():
            page = self.pages[rid]
            assert len(self.free) >= page.n_blocks, "free list out of sync"
            page.phys = [self.free.pop() for _ in range(page.n_blocks)]
            if page.host_blocks is not None:
                # page fault: copy the blocks back from the usrmem tier
                t0 = time.perf_counter()
                blocks = iter(page.host_blocks)
                for path, leaf in cache_leaves(self._caches):
                    if leaf_kind(path) != "kv":
                        continue
                    idx = torch.tensor(page.phys, device=leaf.device)
                    leaf.index_copy_(leaf_axis(path), idx,
                                     next(blocks).to(leaf.device))
                self._drop_host(page)
                self.page_faults += 1
                self.page_fault_s += time.perf_counter() - t0
                if self.on_fault is not None:
                    self.on_fault(page.n_blocks)
            return tuple(page.phys)
        return load

    def _on_evict(self, entry: DCEntry):
        """Writeback under LRU pressure: a request's private blocks are
        copied to the host tier before they return to the free list."""
        t0 = time.perf_counter()
        rid = int(entry.name.split(":", 1)[1])
        page = self.pages[rid]
        page.host_blocks = []
        for path, leaf in cache_leaves(self._caches):
            if leaf_kind(path) == "kv":
                idx = torch.tensor(page.phys, device=leaf.device)
                page.host_blocks.append(
                    _to_host(leaf.index_select(leaf_axis(path), idx)))
        if self.uva is not None:
            for i, blk in enumerate(page.host_blocks):
                self.uva.bind_host(f"kvpage:{rid}/{i}", blk)
        self.free.extend(page.phys)
        page.phys = None
        self.swap_outs += 1
        self.swap_out_s += time.perf_counter() - t0

    def _drop_host(self, page: _Page):
        if page.host_blocks is not None and self.uva is not None:
            for i in range(len(page.host_blocks)):
                self.uva.free(f"kvpage:{page.rid}/{i}")
        page.host_blocks = None

    # -- invariants / introspection -------------------------------------------
    def check_invariants(self):
        """Assert the arena's ownership and accounting invariants:

          * every physical block has exactly ONE owner — the free list or
            a resident page's private set — and together they cover the
            whole arena (nothing leaked, nothing double-freed; the sink is
            no block of the arena's);
          * the DC table's byte accounting is congruent with the free list.
        """
        owners: Dict[int, str] = {}

        def own(b, who):
            assert 0 <= b < self.arena_blocks, (b, who)
            assert b not in owners, f"block {b} owned by {owners[b]} and {who}"
            owners[b] = who

        for b in self.free:
            own(b, "free")
        for rid, p in self.pages.items():
            if p.phys is not None:
                for b in p.phys:
                    own(b, f"kv:{rid}")
        assert len(owners) == self.arena_blocks, \
            (len(owners), self.arena_blocks)
        used = self.arena_blocks - len(self.free)
        assert self.table.resident_bytes == used * self.block_bytes, \
            (self.table.resident_bytes, used, self.block_bytes)

    def report(self) -> Dict[str, Any]:
        t = self.table.report()
        host_bytes = sum(
            sum(b.numel() * b.element_size() for b in p.host_blocks)
            for p in self.pages.values() if p.host_blocks is not None)
        return {
            "arena_blocks": self.arena_blocks,
            "block_bytes": self.block_bytes,
            "capacity_bytes": t["capacity"],
            "free_blocks": len(self.free),
            "occupancy": self.arena_occupancy(),
            "hits": self.hits,            # resumes served without a copy
            "loads": self.loads,          # block allocations (incl. faults)
            "evictions": t["evictions"],  # LRU writebacks
            "page_faults": self.page_faults,
            "swap_outs": self.swap_outs,
            "grown_blocks": self.grown_blocks,        # speculative grows
            "reclaimed_blocks": self.reclaimed_blocks,  # speculative trims
            # host time per move, copies included (they are synchronous)
            "swap_out_ms": 1e3 * self.swap_out_s / max(self.swap_outs, 1),
            "page_fault_ms": (1e3 * self.page_fault_s
                              / max(self.page_faults, 1)),
            "tiers": {USRCORE: t["resident_bytes"], USRMEM: host_bytes},
        }
