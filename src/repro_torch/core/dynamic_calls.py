"""dynamic_calls — on-demand paging with a jump table (paper §3.4, C4),
port of ``repro/core/dynamic_calls.py``.

Epiphany: functions marked ``__dynamic_call`` live in global memory; the
first call routes through a jump table to the DC loader, which copies the
instructions into a local arena and patches the table so later calls pay a
single branch.  A reset invalidates the arena ("staged" applications).

Here the pages are data: tensors resident in host memory (the "global"
tier) are copied into device memory (the "local" arena) on first use.  MoE
experts and the paged KV cache's per-request blocks
(:mod:`repro_torch.core.paging`) are the page granularities.

The arena has a byte capacity and an LRU policy with pinning; ``reset()``
is the paper's table invalidation.  The first-call cost is the page copy;
subsequent calls are a dict hit (the "single branch indirection").
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclass
class DCEntry:
    name: str
    loader: Callable[[], Any]       # host -> device materialization
    size_bytes: int
    pins: int = 0                   # pin refcount; > 0 = not evictable
    # populated when resident:
    value: Optional[Any] = None
    loaded_at: float = 0.0
    last_use: float = 0.0
    loads: int = 0
    hits: int = 0

    @property
    def pinned(self) -> bool:
        return self.pins > 0


class DynamicCallTable:
    """Jump table + LRU arena for host-resident pages.

    ``on_evict(entry)`` is called *before* a victim's value is dropped —
    the writeback hook for pages whose arena-resident state must survive
    eviction (the paged KV cache copies a victim's blocks back to the host
    tier here).  It fires on LRU pressure AND on ``reset()`` (a stateful
    arena must never lose pages to an invalidation); only ``remove`` — the
    page is gone for good — skips it.

    ``device`` is where :meth:`register_host_array` pages load to;
    ``None`` means the card (``"cuda"``).
    """

    def __init__(self, capacity_bytes: int,
                 on_evict: Optional[Callable[[DCEntry], None]] = None, *,
                 device=None):
        self.capacity = int(capacity_bytes)
        self.on_evict = on_evict
        self.device = torch.device(device or "cuda")
        self._entries: Dict[str, DCEntry] = {}
        self._resident_bytes = 0
        self.evictions = 0

    # -- registration (the compile-time jump-table generation) ----------------
    def register(self, name: str, loader: Callable[[], Any],
                 size_bytes: int, pinned: bool = False) -> DCEntry:
        if size_bytes > self.capacity and not pinned:
            raise ValueError(
                f"page '{name}' ({size_bytes}B) exceeds arena capacity "
                f"({self.capacity}B)")
        e = DCEntry(name=name, loader=loader, size_bytes=int(size_bytes),
                    pins=1 if pinned else 0)
        self._entries[name] = e
        return e

    def register_host_array(self, name: str, host: torch.Tensor,
                            pinned: bool = False) -> DCEntry:
        """A page backed by one CPU tensor, copied to the table's device
        on load."""
        return self.register(name, lambda: host.to(self.device),
                             host.numel() * host.element_size(),
                             pinned=pinned)

    # -- the call path ------------------------------------------------------------
    def call(self, name: str) -> Any:
        """Return the resident page, loading (and evicting) if needed."""
        e = self._entries[name]
        now = time.perf_counter()
        if e.value is not None:           # patched-branch fast path
            e.last_use = now
            e.hits += 1
            return e.value
        self._make_room(e.size_bytes, exclude=name)
        e.value = e.loader()
        e.loaded_at = e.last_use = time.perf_counter()
        e.loads += 1
        self._resident_bytes += e.size_bytes
        return e.value

    def _make_room(self, need: int, exclude: str):
        if need > self.capacity:
            raise MemoryError(f"page of {need}B cannot fit arena "
                              f"({self.capacity}B)")
        while self._resident_bytes + need > self.capacity:
            victims = [e for e in self._entries.values()
                       if e.value is not None and not e.pinned
                       and e.name != exclude]
            if not victims:
                raise MemoryError("arena full of pinned pages")
            lru = min(victims, key=lambda e: e.last_use)
            self._evict(lru, writeback=True)

    def _evict(self, e: DCEntry, writeback: bool = False):
        if writeback and self.on_evict is not None:
            self.on_evict(e)
        e.value = None
        self._resident_bytes -= e.size_bytes
        self.evictions += 1

    # -- management ------------------------------------------------------------
    def reset(self):
        """Invalidate every non-pinned page (the paper's DC table reset).
        Pages with a writeback hook registered are written back first, so
        a reset over a stateful arena (paged KV) is lossless."""
        for e in self._entries.values():
            if e.value is not None and not e.pinned:
                self._evict(e, writeback=True)

    def remove(self, name: str):
        """Deregister a page entirely (no writeback, not an eviction) —
        the page's backing data is gone, e.g. its request completed."""
        e = self._entries.pop(name, None)
        if e is not None and e.value is not None:
            self._resident_bytes -= e.size_bytes
            e.value = None

    def resize(self, name: str, size_bytes: int):
        """Adjust a RESIDENT page's size in place (speculative block
        over-allocation grows a KV page for one verify step, reclaim
        shrinks it back).  The caller guarantees the new total fits the
        arena — growth must come from genuinely free capacity, never by
        displacing another page."""
        e = self._entries[name]
        assert e.value is not None, f"resize of non-resident page '{name}'"
        size_bytes = int(size_bytes)
        self._resident_bytes += size_bytes - e.size_bytes
        assert 0 <= self._resident_bytes <= self.capacity, \
            (name, size_bytes, self._resident_bytes, self.capacity)
        e.size_bytes = size_bytes

    def is_resident(self, name: str) -> bool:
        e = self._entries.get(name)
        return e is not None and e.value is not None

    def is_pinned(self, name: str) -> bool:
        e = self._entries.get(name)
        return e is not None and e.pinned

    @property
    def evictable_bytes(self) -> int:
        """Bytes reclaimable without touching pinned pages."""
        return sum(e.size_bytes for e in self._entries.values()
                   if e.value is not None and not e.pinned)

    def pin(self, name: str):
        """Increment a page's pin refcount.  Pins COUNT: a page shared by
        several mappers stays unevictable until every mapper unpins."""
        self._entries[name].pins += 1

    def unpin(self, name: str):
        e = self._entries[name]
        assert e.pins > 0, f"unpin of unpinned page '{name}'"
        e.pins -= 1

    @property
    def resident_bytes(self) -> int:
        return self._resident_bytes

    def resident(self):
        return [e.name for e in self._entries.values() if e.value is not None]

    def report(self) -> Dict[str, Any]:
        return {
            "capacity": self.capacity,
            "resident_bytes": self._resident_bytes,
            "evictions": self.evictions,
            "pages": {e.name: {"size": e.size_bytes, "loads": e.loads,
                               "hits": e.hits, "pinned": e.pinned,
                               "resident": e.value is not None}
                      for e in self._entries.values()},
        }


class PagedExpertStore:
    """MoE-specialized DC table: experts are pages, routing stats drive
    prefetch.  Holds a model whose experts exceed device memory (the
    paper's 'staged application' scenario)."""

    def __init__(self, table: DynamicCallTable):
        self.table = table
        self.route_counts: Dict[str, int] = {}

    def add_expert(self, layer: int, expert: int, host_weights) -> str:
        """``host_weights``: a CPU tensor or a nested dict of them."""
        name = f"L{layer}/E{expert}"
        size = sum(t.numel() * t.element_size()
                   for t in _tensors(host_weights))
        self.table.register(
            name, lambda hw=host_weights: _to(hw, self.table.device), size)
        return name

    def lookup(self, layer: int, expert: int):
        name = f"L{layer}/E{expert}"
        self.route_counts[name] = self.route_counts.get(name, 0) + 1
        return self.table.call(name)

    def hot_set(self, k: int):
        return sorted(self.route_counts, key=self.route_counts.get,
                      reverse=True)[:k]
