"""paging — paged KV-cache arena over the dynamic-call table (paper §3.4),
port of ``repro/core/paging.py``.

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

Cross-request prefix sharing (one physical copy, many logical mappings):
a radix trie over ``kv_block``-sized token chunks indexes **shared
blocks**.  A new request whose prompt walks the trie maps every
fully-matched block read-only into its block-table row with a refcount
bump, and computes from the (block-aligned) divergence point into fresh
private blocks, the copy-on-write of this arena.  A shared block enters
the row as ``-(phys + 2)``, which the device-side write path drops (its
guard is ``phys >= 0``) while the gather decodes it back.  ``release``
decrements refcounts; a block returns to the free list only under LRU
pressure once no active mapper pins it, and because every published
block is write-through copied into a :class:`PrefixStore` (host memory,
keyed by a hash of the token chain, not by request), a popular prefix
survives arena eviction and engine reboots without a new prefill.  The
store holds CPU tensors (pinned when the arena is on the card), not numpy
arrays as the reference's does: numpy has no bfloat16.

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

import hashlib
import struct
import time
from dataclasses import dataclass, field
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


def _tokens(prompt) -> List[int]:
    return [int(t) for t in torch.as_tensor(prompt).reshape(-1).tolist()]


class PrefixStore:
    """Cross-engine host tier for published prefix KV blocks.

    Keyed by content-chain hash (prefix identity), not by request id: a
    popular prefix outlives every request that built it.  Entries are the
    write-through backing of ``kvshare:`` arena pages, so arena eviction
    of a cold shared block is free (the copy already exists) and a fault
    back in is one host->device copy per leaf.  An engine rebooted on the
    same store re-seeds its trie from here."""

    def __init__(self):
        self.entries: Dict[str, Dict[str, Any]] = {}
        self.puts = 0
        self.gets = 0

    def put(self, key: str, parent: Optional[str], chunk: Tuple[int, ...],
            blocks: List[torch.Tensor]):
        self.entries[key] = {"parent": parent, "chunk": tuple(chunk),
                             "blocks": blocks}
        self.puts += 1

    def get(self, key: str) -> List[torch.Tensor]:
        self.gets += 1
        return self.entries[key]["blocks"]

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    def report(self) -> Dict[str, Any]:
        host_bytes = sum(sum(b.numel() * b.element_size() for b in e["blocks"])
                         for e in self.entries.values())
        return {"entries": len(self.entries), "host_bytes": host_bytes,
                "puts": self.puts, "gets": self.gets}


@dataclass
class _SharedBlock:
    """One trie node: a ``kv_block``-token chunk of some published prefix,
    backed by one arena block while resident and by its PrefixStore entry
    always (write-through)."""
    key: str                          # content-chain hash (store key)
    chunk: Tuple[int, ...]            # the kv_block token ids it covers
    parent: Optional["_SharedBlock"] = None
    refs: int = 0                     # live block-table mappings
    phys: Optional[int] = None        # resident physical block id
    registered: bool = False          # has a DC entry in the table
    hits: int = 0                     # times matched at admission
    children: Dict[Tuple[int, ...], "_SharedBlock"] = field(
        default_factory=dict)


@dataclass
class _Page:
    """One request's KV footprint: a (possibly empty) read-only shared
    prefix of trie blocks plus private blocks, resident (phys mapped into
    the arena) or swapped out (host copies of blocks + recurrent rows)."""
    rid: int
    n_blocks: int                           # total logical blocks
    base_blocks: int = 0                    # admission-time reservation
    preempted: bool = False                 # swapped out of its slot
    shared: List[_SharedBlock] = field(default_factory=list)
    phys: Optional[List[int]] = None        # resident private block ids
    host_blocks: Optional[List[torch.Tensor]] = None  # swapped-out KV
    state_rows: Optional[List[torch.Tensor]] = None   # rows at preempt

    @property
    def n_private(self) -> int:
        return self.n_blocks - len(self.shared)


class PagedKVManager:
    """Host-side paging authority for one serving engine's KV arena.

    Residency policy (LRU, pinning, byte capacity) is delegated to a
    :class:`DynamicCallTable`; this class owns the physical-block free
    list, the host (usrmem) tier, the prefix trie and the cache-tree edits
    that map and unmap block-table rows.  All methods that move data take
    the live cache tree, edit it in place and return it — they may only be
    called between program executions.

    ``on_fault(blocks)`` is called once per page fault with the blocks it
    copied back (1 for a shared block faulted back from the store).  With
    ``prefix_store`` set (and ``kv_block`` given), the manager keeps a
    radix trie of published prefix blocks: :meth:`match_prefix` walks a
    prompt against it, :meth:`admit` maps matched blocks read-only with a
    refcount bump, and :meth:`publish` turns a freshly prefilled request's
    full prompt blocks into new trie nodes (write-through host copies).
    The trie is re-seeded from the store at construction, so a store that
    outlives the engine keeps its prefixes warm.
    """

    def __init__(self, arena_blocks: int, block_bytes: int, *,
                 uva=None, on_fault: Optional[Callable[[int], None]] = None,
                 kv_block: Optional[int] = None,
                 prefix_store: Optional[PrefixStore] = None):
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
        self.kv_block = int(kv_block) if kv_block else None
        self.store = prefix_store
        self._trie: Dict[Tuple[int, ...], _SharedBlock] = {}
        self._shared: Dict[str, _SharedBlock] = {}
        self.page_faults = 0      # swap-ins that copied blocks from host
        self.swap_outs = 0        # LRU writebacks to the host tier
        self.hits = 0             # table calls served by resident pages
        self.loads = 0            # table calls that ran the loader
        self.grown_blocks = 0     # speculative over-allocations (grow)
        self.reclaimed_blocks = 0  # speculative reclaims (trim_to_base)
        self.swap_out_s = 0.0     # host seconds spent in swap-outs
        self.page_fault_s = 0.0   # host seconds spent in page faults
        self.prefix_hits = 0      # shared blocks mapped at admission
        self.published_blocks = 0  # trie nodes created by publish()
        self.shared_faults = 0    # shared blocks copied back from the store
        self.shared_evictions = 0  # cold shared blocks dropped under pressure
        self._caches = None       # staged tree during table ops
        if self.store is not None:
            assert self.kv_block, "prefix sharing needs kv_block"
            self._rebuild_trie()

    # -- capacity ------------------------------------------------------------
    def _name(self, rid: int) -> str:
        return f"kv:{rid}"

    @staticmethod
    def _shared_name(sb: _SharedBlock) -> str:
        return f"kvshare:{sb.key}"

    def can_admit(self, rid: int, n_blocks: int,
                  shared: Optional[List[_SharedBlock]] = None) -> bool:
        """True when the blocks ``rid`` needs can be made resident without
        touching a pinned (actively mapped) page.

        For a fresh admission, ``shared`` (a :meth:`match_prefix` result)
        discounts already-resident shared blocks (they cost nothing)
        while matched-but-cold ones still need a block faulted in.  For a
        KNOWN rid (a preempted request about to resume) the page's own
        shared list is consulted instead: its private blocks may still be
        resident (a free resume) while part of its shared head was evicted
        under pressure and must fault back.  Either way, blocks this call
        is about to pin (matched resident shared blocks and the page's own
        resident private run) must not double as eviction victims."""
        page = self.pages.get(rid)
        if page is not None:
            shared, n_private = page.shared, page.n_private
        else:
            shared = list(shared or [])
            n_private = int(n_blocks) - len(shared)
        need = sum(1 for sb in shared if sb.phys is None) * self.block_bytes
        own_resident = self.table.is_resident(self._name(rid))
        if not own_resident:
            need += n_private * self.block_bytes
        if need == 0:
            return True
        if need > self.table.capacity:
            return False
        free = self.table.capacity - self.table.resident_bytes
        reserved = sum(self.block_bytes for sb in shared
                       if sb.phys is not None
                       and not self.table.is_pinned(self._shared_name(sb)))
        if own_resident and not self.table.is_pinned(self._name(rid)):
            reserved += n_private * self.block_bytes
        return need <= free + self.table.evictable_bytes - reserved

    def arena_occupancy(self) -> float:
        used = self.arena_blocks - len(self.free)
        return used / max(self.arena_blocks, 1)

    # -- prefix trie ----------------------------------------------------------
    def match_prefix(self, prompt) -> List[_SharedBlock]:
        """Walk ``prompt`` against the trie in ``kv_block``-sized chunks.

        Returns the longest chain of fully-matched shared blocks, capped
        at ``(len(prompt) - 1) // kv_block``: strictly below the block
        that will hold the prompt's final position, so a matched request
        always computes at least one suffix token (its first-token logits)
        and never writes inside a shared block."""
        if self.store is None:
            return []
        toks = _tokens(prompt)
        bs = self.kv_block
        out: List[_SharedBlock] = []
        level = self._trie
        for i in range(max(len(toks) - 1, 0) // bs):
            sb = level.get(tuple(toks[i * bs:(i + 1) * bs]))
            if sb is None:
                break
            out.append(sb)
            level = sb.children
        return out

    @staticmethod
    def _chain_key(parent: Optional[_SharedBlock],
                   chunk: Tuple[int, ...]) -> str:
        """The reference's key: blake2b-64 of the parent's key and the
        chunk as little-endian int64."""
        h = hashlib.blake2b(digest_size=8)
        h.update((parent.key if parent is not None else "").encode())
        h.update(struct.pack(f"<{len(chunk)}q", *chunk))
        return h.hexdigest()

    def _rebuild_trie(self):
        """Re-seed the trie from a PrefixStore that outlived its engine:
        every entry becomes a cold shared block that faults back in from
        its host copy on first match."""
        nodes = {k: _SharedBlock(key=k, chunk=e["chunk"])
                 for k, e in self.store.entries.items()}
        for k, e in self.store.entries.items():
            sb, pk = nodes[k], e["parent"]
            if pk is None:
                self._trie[sb.chunk] = sb
            elif pk in nodes:
                sb.parent = nodes[pk]
                nodes[pk].children[sb.chunk] = sb
            else:
                continue          # orphaned chain: unreachable, skip
            self._shared[k] = sb

    def _remap_shared(self, sb: _SharedBlock, caches):
        """(Re-)map one shared block for an EXISTING mapper (a preempted
        request resuming): fault the block back from the store if pressure
        evicted it, re-pin it (refcounted pins).  No refcount bump: the
        mapper never gave its reference up."""
        name = self._shared_name(sb)
        if not sb.registered:
            self.table.register(name, self._shared_loader(sb),
                                self.block_bytes)
            sb.registered = True
        if sb.phys is not None:
            self.hits += 1
        else:
            self.loads += 1
        self._caches = caches
        self.table.call(name)
        self.table.pin(name)
        caches, self._caches = self._caches, None
        return caches

    def _map_shared(self, sb: _SharedBlock, caches):
        """Map one shared block for a NEW mapper: fault in if cold, pin
        once per mapper, and take the mapper's reference."""
        caches = self._remap_shared(sb, caches)
        sb.refs += 1
        sb.hits += 1
        return caches

    def _shared_loader(self, sb: _SharedBlock):
        def load():
            if sb.phys is not None:
                # publish() donation: the block is already in the arena
                # (it was the donor's private block); adopt it in place
                return sb.phys
            assert self.free, "free list out of sync (shared fault)"
            sb.phys = self.free.pop()
            blocks = iter(self.store.get(sb.key))
            for path, leaf in cache_leaves(self._caches):
                if leaf_kind(path) != "kv":
                    continue
                idx = torch.tensor([sb.phys], device=leaf.device)
                leaf.index_copy_(leaf_axis(path), idx,
                                 next(blocks).to(leaf.device, leaf.dtype))
            self.shared_faults += 1
            if self.on_fault is not None:
                self.on_fault(1)
            return sb.phys
        return load

    def publish(self, rid: int, prompt, slot: int, caches):
        """Turn a freshly prefilled request's fully-prompt-covered blocks
        into shared trie nodes.

        Each published block is DONATED from the request's private set to
        a new ``kvshare:`` entry (byte accounting moves with it), copied
        through to the PrefixStore, and re-encoded write-protected in the
        slot's block-table row.  The publisher keeps mapping the block
        (refcount 1); later requests matching the same token chain map the
        same physical copy.  Blocks already shared (matched at admission)
        are skipped; a chunk another request already published drops the
        duplicate copy.  The new blocks' host copies are one gather per
        leaf, made after the trie walk (nothing writes the arena in
        between)."""
        if self.store is None:
            return caches
        page = self.pages[rid]
        assert page.phys is not None, f"publish of non-resident page {rid}"
        toks = _tokens(prompt)
        bs = self.kv_block
        n_pub = min(len(toks) // bs, page.n_blocks)
        start = len(page.shared)
        kv = [(path, leaf) for path, leaf in cache_leaves(caches)
              if leaf_kind(path) == "kv"]
        if n_pub <= start or not kv:
            return caches           # nothing new, or attention-free family
        parent = page.shared[-1] if page.shared else None
        level = parent.children if parent is not None else self._trie
        name = self._name(rid)
        new: List[_SharedBlock] = []
        for i in range(start, n_pub):
            chunk = tuple(toks[i * bs:(i + 1) * bs])
            phys = page.phys.pop(0)
            page.shared.append(None)        # placeholder, set below
            self.table.resize(name, page.n_private * self.block_bytes)
            sb = level.get(chunk)
            if sb is None:
                key = self._chain_key(parent, chunk)
                sb = _SharedBlock(key=key, chunk=chunk, parent=parent,
                                  phys=phys)
                level[chunk] = sb
                self._shared[key] = sb
                new.append(sb)
                self.published_blocks += 1
            elif sb.phys is None:
                sb.phys = phys              # donate ours as the resident copy
            else:
                self.free.append(phys)      # drop our duplicate copy
            page.shared[-1] = sb
            caches = self._map_shared(sb, caches)
            parent, level = sb, sb.children
        if new:
            hosts = []
            for path, leaf in kv:
                idx = torch.tensor([sb.phys for sb in new],
                                   device=leaf.device)
                hosts.append((leaf_axis(path),
                              _to_host(leaf.index_select(leaf_axis(path),
                                                         idx))))
            for i, sb in enumerate(new):
                blocks = [h.narrow(axis, i, 1) for axis, h in hosts]
                self.store.put(sb.key,
                               sb.parent.key if sb.parent else None,
                               sb.chunk, blocks)
                if self.uva is not None:
                    for j, blk in enumerate(blocks):
                        self.uva.bind_host(f"kvshare:{sb.key}/{j}", blk)
        return self._write_row(caches, slot, page)

    # -- admission / release --------------------------------------------------
    def admit(self, rid: int, n_blocks: int, slot: int, caches,
              shared: Optional[List[_SharedBlock]] = None):
        """Reserve and map a new request's blocks; returns the tree with
        the slot's block-table row written.  May evict (write back) idle
        pages to make room.  ``shared`` (from :meth:`match_prefix`) maps
        those trie blocks read-only at the head of the row: refcount
        bumped, no private block spent."""
        assert rid not in self.pages, rid
        shared = list(shared or [])
        assert len(shared) < max(int(n_blocks), 1) or not shared, \
            (rid, len(shared), n_blocks)
        page = _Page(rid=rid, n_blocks=int(n_blocks),
                     base_blocks=int(n_blocks), shared=shared)
        self.pages[rid] = page
        for sb in shared:
            caches = self._map_shared(sb, caches)
        self.prefix_hits += len(shared)
        name = self._name(rid)
        self.table.register(name, self._loader(rid),
                            page.n_private * self.block_bytes)
        caches = self._call_page(name, caches)
        return self._write_row(caches, slot, page)

    def release(self, rid: int, slot: int, caches):
        """Request finished: free its private blocks, unref its shared
        ones and unmap its row.

        Safe for a request that finishes while PREEMPTED (slot == -1, page
        unpinned, private blocks possibly already written back to the host
        tier): evicted pages have no resident blocks to free (no double
        free), their ``kvpage:`` host-tier entries are dropped exactly
        once, no block-table row is touched (the slot was already cleared
        at preemption — and ``-1`` must never index a live row), and the
        shared pins preemption already dropped are not dropped twice.
        Shared blocks lose the mapper's reference; at zero refs they stay
        resident until LRU pressure evicts them (their PrefixStore copy
        persists either way)."""
        page = self.pages.pop(rid)
        if self.table.is_resident(self._name(rid)) and page.phys is not None:
            self.free.extend(page.phys)
        self.table.remove(self._name(rid))
        self._drop_host(page)
        for sb in page.shared:
            assert sb.refs > 0, (rid, sb.key)
            sb.refs -= 1
            if not page.preempted:
                self.table.unpin(self._shared_name(sb))
        if slot < 0:
            return caches           # finished while preempted: no row to clear
        return self._clear_row(caches, slot)

    def grow(self, rid: int, n_total: int, slot: int, caches):
        """Speculative block over-allocation: best-effort extend a resident
        page's PRIVATE mapping toward ``n_total`` total blocks from the
        FREE list only (never by evicting another page, and never by
        grabbing a shared block: a failed grow just means overshoot writes
        drop, which verify rollback tolerates)."""
        page = self.pages[rid]
        assert page.phys is not None, f"grow of non-resident page {rid}"
        extra = min(int(n_total) - page.n_blocks, len(self.free))
        if extra <= 0:
            return caches
        page.phys.extend(self.free.pop() for _ in range(extra))
        page.n_blocks += extra
        self.grown_blocks += extra
        self.table.resize(self._name(rid),
                          page.n_private * self.block_bytes)
        return self._write_row(caches, slot, page)

    def trim_to_base(self, rid: int, slot: int, caches):
        """Reclaim on rejection: shrink a grown page back to its
        admission-time reservation, returning the speculative PRIVATE tail
        blocks to the free list and unmapping them from the slot's row
        (the shared prefix sits ahead of the private run and is never part
        of the grown tail).  The verify program restored the freed blocks'
        bytes before this runs, so they are bit-identical to never having
        been written."""
        page = self.pages[rid]
        extra = page.n_blocks - page.base_blocks
        if extra <= 0 or page.phys is None:
            return caches
        base_private = page.base_blocks - len(page.shared)
        assert base_private >= 0, (rid, page.base_blocks, len(page.shared))
        self.free.extend(page.phys[base_private:])
        del page.phys[base_private:]
        page.n_blocks = page.base_blocks
        self.reclaimed_blocks += extra
        self.table.resize(self._name(rid),
                          page.n_private * self.block_bytes)
        return self._write_row(caches, slot, page)

    def reset(self, caches):
        """The paper's DC-table reset applied to the KV arena: every
        non-pinned (preempted) page writes back to the host tier and frees
        its blocks; active (pinned) pages stay resident.  Lossless — a
        later resume page-faults the blocks back in, and unreferenced
        shared blocks re-load from their write-through store copy.
        (Always reset through this method, not ``table.reset()`` directly:
        the writeback hook needs the cache tree staged.)"""
        self._caches = caches
        self.table.reset()
        caches, self._caches = self._caches, None
        return caches

    # -- preemption / resume --------------------------------------------------
    def preempt(self, rid: int, slot: int, caches):
        """Swap a request out of its slot: the per-slot recurrent rows are
        copied to host eagerly (the slot is reused immediately); the
        private KV blocks stay resident — unpinned — until LRU pressure
        writes them back (lazy swap-out, so a quick resume is free).  Its
        shared blocks keep their refcounts (the trie mapping persists) but
        drop their pins with the row: under pressure the shared head is
        evictable like everything else unpinned (for free: its store copy
        is the write-through original) and a resume faults it back.
        Pinning it across preemption would deadlock a small arena: enough
        preempted requests could pin every block while none of them can
        come back."""
        page = self.pages[rid]
        page.state_rows = [_to_host(leaf.select(leaf_axis(path), slot))
                           for path, leaf in cache_leaves(caches)
                           if leaf_kind(path) == "state"]
        self.table.unpin(self._name(rid))
        for sb in page.shared:
            self.table.unpin(self._shared_name(sb))
        page.preempted = True
        return self._clear_row(caches, slot)

    def resume(self, rid: int, slot: int, caches):
        """Swap a preempted request back in.  A still-resident page is a
        table hit (re-map only); an evicted one is a page fault that
        copies every private block back from the host tier, and any
        shared-head block pressure evicted is copied back from its
        PrefixStore entry (a shared fault).  The state rows are copied
        back into the slot."""
        page = self.pages[rid]
        for sb in page.shared:
            caches = self._remap_shared(sb, caches)
        caches = self._call_page(self._name(rid), caches)
        caches = self._write_row(caches, slot, page)
        rows = iter(page.state_rows)
        for path, leaf in cache_leaves(caches):
            if leaf_kind(path) == "state":
                leaf.select(leaf_axis(path), slot).copy_(next(rows))
        page.state_rows = None
        page.preempted = False
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
        for j, sb in enumerate(page.shared):
            assert sb.phys is not None, (page.rid, sb.key)
            row[j] = encode_shared(sb.phys)      # read-only mapping
        row[len(page.shared):page.n_blocks] = torch.tensor(
            page.phys, dtype=torch.int32)
        bt[slot].copy_(row)
        return caches

    def _clear_row(self, caches, slot: int):
        caches["block_table"][slot].fill_(-1)
        return caches

    # -- the DC loader / evictor (host<->device block moves) ------------------
    def _loader(self, rid: int):
        def load():
            page = self.pages[rid]
            assert len(self.free) >= page.n_private, "free list out of sync"
            page.phys = [self.free.pop() for _ in range(page.n_private)]
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
                    self.on_fault(page.n_private)
            return tuple(page.phys)
        return load

    def _on_evict(self, entry: DCEntry):
        """Writeback under LRU pressure, dispatched on the page kind:
        ``kv:`` (a request's private blocks) is copied to the host tier
        before its blocks return to the free list; ``kvshare:`` (a cold
        shared block) frees directly, its write-through PrefixStore copy
        already exists."""
        kind, ident = entry.name.split(":", 1)
        if kind == "kvshare":
            # refs > 0 is legal here: every remaining mapper is preempted
            # (their rows are cleared, so no device mapping dangles), and
            # their resume re-faults the block from its store copy
            sb = self._shared[ident]
            self.free.append(sb.phys)
            sb.phys = None
            self.shared_evictions += 1
            return
        t0 = time.perf_counter()
        rid = int(ident)
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

          * every physical block has exactly ONE owner — the free list, a
            resident page's private set, or a resident shared block — and
            together they cover the whole arena (nothing leaked, nothing
            double-freed; the sink is no block of the arena's);
          * every shared block's refcount equals its live block-table
            mappings;
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
        for key, sb in self._shared.items():
            if sb.phys is not None:
                own(sb.phys, f"kvshare:{key}")
        assert len(owners) == self.arena_blocks, \
            (len(owners), self.arena_blocks)
        mapped: Dict[str, int] = {}
        for p in self.pages.values():
            for sb in p.shared:
                mapped[sb.key] = mapped.get(sb.key, 0) + 1
        for key, sb in self._shared.items():
            assert sb.refs == mapped.get(key, 0), \
                (key, sb.refs, mapped.get(key, 0))
        used = self.arena_blocks - len(self.free)
        assert self.table.resident_bytes == used * self.block_bytes, \
            (self.table.resident_bytes, used, self.block_bytes)

    def report(self) -> Dict[str, Any]:
        t = self.table.report()
        host_bytes = sum(
            sum(b.numel() * b.element_size() for b in p.host_blocks)
            for p in self.pages.values() if p.host_blocks is not None)
        rep = {
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
        if self.store is not None:
            rep["prefix"] = {
                "trie_blocks": len(self._shared),
                "resident_shared": sum(
                    1 for sb in self._shared.values()
                    if sb.phys is not None),
                "prefix_hits": self.prefix_hits,
                "published_blocks": self.published_blocks,
                "shared_faults": self.shared_faults,
                "shared_evictions": self.shared_evictions,
                "store": self.store.report(),
            }
        return rep
