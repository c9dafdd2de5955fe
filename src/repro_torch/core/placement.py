"""placement — memory-placement qualifiers (paper §3.2/§3.4, contribution
C1), port of ``repro/core/placement.py``.

Epiphany: ``_usrcore_call`` / ``_usrmem_call`` / ``__dynamic_call``
qualifiers let the programmer place each function in scarce local memory,
slow global memory, or the paged arena — and Table 2 shows the
footprint/latency trade-off of each layout.

Here they are per-TENSOR placement classes for model state:

    usrcore  — resident in device memory (fast, scarce)
    usrmem   — resident in host memory, streamed on use (slow, abundant)
    dynamic  — host-resident, paged into a device arena on demand with LRU
               (repro_torch.core.dynamic_calls)

A :class:`PlacementPlan` maps parameter paths (regex over ``/``-joined
keys of a nested dict) to classes; applying it partitions a tree into the
three stores and produces the Table-2-style footprint report.  The paged
KV arena (repro_torch.core.paging) names its two tiers by these classes.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.dynamic_calls import DynamicCallTable

USRCORE = "usrcore"
USRMEM = "usrmem"
DYNAMIC = "dynamic"
CLASSES = (USRCORE, USRMEM, DYNAMIC)


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + (str(k),))]
    return [(prefix, tree)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class PlacementPlan:
    """Ordered (regex -> class) rules; first match wins; default usrcore."""
    rules: List[Tuple[str, str]] = field(default_factory=list)
    default: str = USRCORE

    def add(self, pattern: str, klass: str) -> "PlacementPlan":
        assert klass in CLASSES, klass
        self.rules.append((pattern, klass))
        return self

    def classify(self, path: str) -> str:
        for pat, klass in self.rules:
            if re.search(pat, path):
                return klass
        return self.default


@dataclass
class PlacedTree:
    """A tree partitioned by placement class."""
    device: Dict[str, torch.Tensor]       # usrcore
    host: Dict[str, torch.Tensor]         # usrmem (and dynamic's backing)
    paged: Dict[str, str]                 # dynamic: path -> DC page name
    dc_table: Optional[DynamicCallTable]
    keys: Dict[str, Tuple[str, ...]]      # path -> key path in the tree
    paths: List[str]
    classes: Dict[str, str]
    target: torch.device

    def get(self, path: str):
        if path in self.device:
            return self.device[path]
        if path in self.paged:
            return self.dc_table.call(self.paged[path])
        if path in self.host:
            # usrmem: streamed on each use (the slow row of Table 2)
            return self.host[path].to(self.target)
        raise KeyError(path)

    def materialize(self):
        """The full tree with every leaf resolved (pages load on demand)."""
        out: Dict[str, Any] = {}
        for p in self.paths:
            *outer, last = self.keys[p]
            node = out
            for k in outer:
                node = node.setdefault(k, {})
            node[last] = self.get(p)
        return out

    def report(self) -> Dict[str, Any]:
        per = {k: 0 for k in CLASSES}
        for p in self.paths:
            k = self.classes[p]
            if p in self.device:
                per[USRCORE] += _nbytes(self.device[p])
            elif p in self.host and k == USRMEM:
                per[USRMEM] += _nbytes(self.host[p])
            elif p in self.paged:
                per[DYNAMIC] += self.dc_table._entries[self.paged[p]] \
                    .size_bytes
        total = sum(per.values())
        return {"bytes": per, "total": total,
                "fraction": {k: (v / total if total else 0.0)
                             for k, v in per.items()}}


def apply_plan(tree, plan: PlacementPlan, *,
               dc_table: Optional[DynamicCallTable] = None,
               arena_bytes: int = 1 << 30, device=None) -> PlacedTree:
    """Partition ``tree`` (a nested dict of tensors) per the plan.
    ``device`` is the usrcore tier's device; ``None`` means the card."""
    target = torch.device(device or "cuda")
    keys, classes = {}, {}
    dev: Dict[str, torch.Tensor] = {}
    host: Dict[str, torch.Tensor] = {}
    paged: Dict[str, str] = {}
    table = dc_table
    paths = []
    for key, leaf in _flatten(tree):
        path = "/".join(key)
        paths.append(path)
        keys[path] = key
        klass = plan.classify(path)
        classes[path] = klass
        if klass == USRCORE:
            dev[path] = leaf.to(target)
        elif klass == USRMEM:
            host[path] = leaf.cpu()
        else:
            if table is None:
                table = DynamicCallTable(arena_bytes, device=target)
            arr = leaf.cpu()
            table.register_host_array(f"page:{path}", arr)
            paged[path] = f"page:{path}"
            host[path] = arr
    return PlacedTree(device=dev, host=host, paged=paged, dc_table=table,
                      keys=keys, paths=paths, classes=classes, target=target)


def footprint(tree) -> int:
    return sum(_nbytes(t) for _, t in _flatten(tree))
