"""Durable per-replica request journal — the zero-lost-requests ledger
(port of ``repro/cluster/journal.py``).

A replica crash discards its ServingEngine whole: queued requests, live
slots, partial generations.  The journal is the host-side record that
survives the crash (and, with a backing file, a supervisor process
restart): every request is appended the moment a replica admits it
(crashes only happen inside a tick, never between admit and append),
every completion is appended when the supervisor collects it, so
``unfinished()`` after a kill is exactly the set of requests the reboot
must replay.  Replays restart from the prompt — greedy decoding is
deterministic, so a replayed request re-emits the identical token stream
and the merged cluster output stays byte-identical to an uninterrupted
single engine.

Format: append-only JSONL, one record per line, fsync'd per append when
file-backed::

    {"op": "submit", "rid": 7, "prompt": [3, 1, 4], "max_new": 8,
     "arrival_time": 0.0}
    {"op": "done", "rid": 7, "generated": [9, 2, 6]}
    {"op": "moved", "rid": 7}        # re-routed to another replica's journal

Recovery cost is a warm boot (the engine installs its programs from the
shared ProgramStore and never runs their functions) — the journal adds
only the replayed requests' prefills.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["RequestJournal"]


class RequestJournal:
    """Append-only request ledger for one replica.

    ``path=None`` keeps the ledger in memory: still kill-safe (the
    supervisor object survives a replica crash — only the engine dies),
    just not supervisor-process-crash-safe.  With a path, every append is
    flushed and fsync'd, and a fresh ``RequestJournal(path)`` over an
    existing file replays the log to reconstruct its state.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else None
        self._submits: Dict[int, dict] = {}        # rid -> submit record
        self._done: Dict[int, List[int]] = {}      # rid -> generated tokens
        self._moved: set = set()                   # rids re-routed elsewhere
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if self.path.exists():
                self._replay_file()
            self._fh = self.path.open("a", encoding="utf-8")

    # -- write path ---------------------------------------------------------
    def _append(self, record: dict):
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def append_submit(self, rid: int, prompt, max_new: int,
                      arrival_time: float = 0.0):
        rec = {"op": "submit", "rid": int(rid),
               "prompt": [int(t) for t in np.asarray(prompt).ravel()],
               "max_new": int(max_new), "arrival_time": float(arrival_time)}
        self._submits[rec["rid"]] = rec
        self._append(rec)

    def mark_done(self, rid: int, generated: List[int]):
        rid = int(rid)
        assert rid in self._submits, f"done for unjournaled rid {rid}"
        self._done[rid] = [int(t) for t in generated]
        self._append({"op": "done", "rid": rid,
                      "generated": self._done[rid]})

    def mark_moved(self, rid: int):
        """This replica no longer owes ``rid`` an answer — the supervisor
        re-routed it to another replica's journal (restart budget
        exhausted)."""
        rid = int(rid)
        assert rid in self._submits, f"moved for unjournaled rid {rid}"
        self._moved.add(rid)
        self._append({"op": "moved", "rid": rid})

    # -- read path ----------------------------------------------------------
    def unfinished(self) -> List[dict]:
        """Submit records not yet done and not moved, in rid order — what a
        failover reboot must replay."""
        return [dict(rec) for rid, rec in sorted(self._submits.items())
                if rid not in self._done and rid not in self._moved]

    def finished(self) -> Dict[int, List[int]]:
        return dict(self._done)

    def record(self, rid: int) -> Optional[dict]:
        """The submit record for ``rid`` (a copy), or ``None`` if this
        replica never journaled it.  Rebalancing reads the record before
        marking the rid moved to the destination replica's journal."""
        rec = self._submits.get(int(rid))
        return dict(rec) if rec is not None else None

    def __len__(self) -> int:
        return len(self._submits)

    def __contains__(self, rid: int) -> bool:
        return int(rid) in self._submits

    # -- persistence --------------------------------------------------------
    def _replay_file(self):
        for line in self.path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue            # torn tail line from a crashed writer
            op, rid = rec.get("op"), int(rec.get("rid", -1))
            if op == "submit":
                self._submits[rid] = rec
            elif op == "done":
                self._done[rid] = [int(t) for t in rec.get("generated", [])]
            elif op == "moved":
                self._moved.add(rid)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __repr__(self):
        return (f"RequestJournal(path={str(self.path)!r}, "
                f"submitted={len(self._submits)}, done={len(self._done)}, "
                f"unfinished={len(self.unfinished())})")
