"""Request router — the cluster's front door (port of
``repro/cluster/router.py``).

One ``Router`` assigns every incoming request to a replica from the
replicas' host-side :meth:`~repro_torch.launch.serve.ServingEngine.snapshot`
views (queue depth, slot occupancy, arena pressure — no device sync).
Policies (``repro_torch.engine_config.ROUTER_POLICIES``):

``least_loaded``
    Score each replica by normalized queue + slot load plus paged-arena
    pressure; lowest score wins.  The default: it is what keeps tail TTFT
    flat when request lengths are mixed.
``round_robin``
    Cycle through live replicas in index order — the baseline policy and
    the fairest one when every request costs the same.
``prefix_affinity``
    Route to the replica whose prefix trie already holds this prompt's
    shared KV blocks: the supervisor feeds :meth:`Router.record` on every
    successful admission, and later prompts with the same
    ``affinity_len``-token prefix go there first (so cross-request prefix
    sharing actually hits — a prefix published on replica 0 is worthless
    to a request routed to replica 1).  Prefixes never seen before fall
    back to a deterministic hash bucket over the live replicas; behind the
    preferred replica, the rest rank by load.

``rank()`` returns ALL candidates best-first rather than a single pick:
the caller walks the order until a replica actually admits (a full
admission queue rejects), so routing composes with engine back-pressure
instead of fighting it.
"""
from __future__ import annotations

import bisect
import zlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.engine_config import ROUTER_POLICIES

__all__ = ["Router"]

# sticky prefix->replica entries kept before the oldest are dropped; the
# map only accelerates placement (a dropped entry degrades to the hash
# bucket), so a small bound is safe
STICKY_CAP = 4096


class Router:
    """Pick a serving order over replicas for each incoming request."""

    def __init__(self, policy: str = "least_loaded", affinity_len: int = 8):
        assert policy in ROUTER_POLICIES, (policy, ROUTER_POLICIES)
        assert affinity_len >= 1, affinity_len
        self.policy = policy
        self.affinity_len = affinity_len
        # round-robin position: the replica INDEX routed last, not a
        # monotonically increasing counter — a counter modulo fleet size
        # re-aliases whenever the fleet grows or shrinks (every elastic
        # scale event would skew the rotation)
        self._rr_last: Optional[int] = None
        self._sticky: Dict[int, int] = {}   # affinity key -> replica whose
                                            # trie holds the prefix
        self.routed = 0

    # -- scoring -------------------------------------------------------------
    @staticmethod
    def load(snapshot: Dict[str, object]) -> float:
        """A replica's load in [0, ~2+]: occupied slots and queued requests
        normalized by batch width, plus paged-arena pressure (a replica
        whose arena is full will defer admissions even with a free slot)."""
        batch = max(int(snapshot.get("batch", 1)), 1)
        backlog = (int(snapshot.get("active", 0)) +
                   int(snapshot.get("queue_depth", 0))) / batch
        return backlog + float(snapshot.get("arena_occupancy", 0.0))

    def _affinity_key(self, prompt) -> int:
        """Deterministic prefix hash (crc32 — NOT ``hash()``, which is
        salted per process and would re-shuffle affinity every reboot).

        Total over every prompt shape: the prefix is padded to a FIXED
        ``affinity_len`` width before hashing, so a prompt SHORTER than
        ``affinity_len`` buckets by its content alone — unpadded, the
        2-token prompt ``[7, 9]`` and the longer ``[7, 9, ...]`` hash
        different byte lengths and can never share a bucket, while two
        short prompts of different lengths could collide on a byte string
        that means something else entirely.  -1 never appears as a token
        id, so the pad is unambiguous.  An empty prompt is just the
        all-pad key, not an error."""
        prefix = np.asarray(prompt, np.int32).ravel()[: self.affinity_len]
        if prefix.size < self.affinity_len:
            prefix = np.concatenate(
                [prefix, np.full(self.affinity_len - prefix.size, -1,
                                 np.int32)])
        return zlib.crc32(prefix.tobytes())

    def record(self, prompt, replica: int):
        """Placement feedback: ``prompt`` was actually admitted by
        ``replica``, whose trie now holds (or will publish) its prefix
        blocks — later prompts with the same prefix rank that replica
        first.  Bounded FIFO: past STICKY_CAP the oldest entry drops."""
        self._sticky[self._affinity_key(prompt)] = int(replica)
        while len(self._sticky) > STICKY_CAP:
            self._sticky.pop(next(iter(self._sticky)))

    def evict(self, replica: int):
        """Drop every sticky entry pointing at ``replica`` — called when a
        replica retires or fails permanently, so stale affinity entries
        are reclaimed immediately instead of leaking until STICKY_CAP
        pressure pushes them out."""
        replica = int(replica)
        for k in [k for k, v in self._sticky.items() if v == replica]:
            del self._sticky[k]

    # -- ranking -------------------------------------------------------------
    def rank(self, prompt, snapshots: Dict[int, Dict[str, object]]
             ) -> List[int]:
        """Replica indices best-first for this prompt.

        ``snapshots`` maps replica index -> its engine snapshot and must
        contain only live replicas; dead ones are simply absent.  The
        caller tries indices in order until one admits.  An EMPTY snapshot
        map (every replica failed or draining) returns [] for every
        policy — never a ZeroDivision out of the affinity modulus.
        """
        if not snapshots:
            return []
        by_load = sorted(snapshots,
                         key=lambda i: (self.load(snapshots[i]), i))
        if self.policy == "round_robin":
            idx = sorted(snapshots)
            # next replica strictly after the last one routed, wrapping —
            # stable under membership change: retiring replica 0 of
            # {0,1,2} after serving it leaves the rotation at 1, and a
            # later grow to {0..3} resumes from the same point
            if self._rr_last is None:
                start = 0
            else:
                start = bisect.bisect_right(idx, self._rr_last) % len(idx)
            order = idx[start:] + idx[:start]
            self._rr_last = order[0]
        elif self.policy == "prefix_affinity":
            idx = sorted(snapshots)
            key = self._affinity_key(prompt)
            sticky = self._sticky.get(key)
            if sticky is not None and sticky in snapshots:
                preferred = sticky   # its trie already holds this prefix
            else:
                preferred = idx[key % len(idx)]
            order = [preferred] + [i for i in by_load if i != preferred]
        else:                        # least_loaded
            order = by_load
        self.routed += 1
        return order
