"""Speculative decoding: model-free draft proposal (prompt lookup), a copy
of the reference's ``repro/spec.py`` (the port imports nothing of the JAX
package, and this module needs no torch).

The serving engine's decode path pays one program dispatch per generated
token; a speculative engine pays one per *verify step*, which scores ``k``
draft tokens at once and accepts the longest greedy-matching prefix
(:func:`repro_torch.models.transformer.verify_decode`).  The drafts come
from an **n-gram prompt-lookup proposer**: it proposes the continuation of
the most recent earlier occurrence of the current suffix n-gram in the
request's own history (prompt + generated tokens).  It needs no weights
and no draft forward, and works alike for every cache layout the engine
serves.  Drafts are free to be wrong: verification accepts exactly the
prefix the target model would have generated anyway, so the stream is
token-for-token the non-speculative one whatever the proposals.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class NGramProposer:
    """Per-request prompt-lookup draft proposer with an incremental index.

    ``observe(tokens)`` appends tokens to the request's history and indexes,
    for every n-gram that has gained a successor token, the position of
    that successor.  ``propose(k)`` looks up the history's final n-gram and
    returns up to ``k`` tokens that followed its most recent *earlier*
    occurrence — always a verbatim slice of the observed history.

    Degenerate inputs are proposals of length zero, never errors: histories
    shorter than ``ngram + 1`` tokens, or whose final n-gram never occurred
    before, propose nothing (the engine then pads the verify call or falls
    back to plain decode).
    """

    def __init__(self, ngram: int = 2):
        assert ngram >= 1, ngram
        self.ngram = ngram
        self.history: List[int] = []
        # suffix n-gram -> positions (ascending) of the tokens that followed
        # each of its occurrences; kept incrementally, O(1) per token
        self._index: Dict[Tuple[int, ...], List[int]] = {}

    def observe(self, tokens: Sequence[int]) -> None:
        n = self.ngram
        for t in tokens:
            p = len(self.history)           # position the new token lands at
            if p >= n:
                self._index.setdefault(
                    tuple(self.history[p - n:p]), []).append(p)
            self.history.append(int(t))

    def propose(self, k: int) -> List[int]:
        n = self.ngram
        if k <= 0 or len(self.history) < n + 1:
            return []
        succs = self._index.get(tuple(self.history[-n:]))
        if not succs:
            return []
        # latest occurrence with k tokens of follow-up; in a tight cycle
        # the very latest match sits at the history's tail and would yield
        # a near-empty proposal, while an occurrence one period earlier
        # yields the same continuation at full length.  (At most k entries
        # are scanned: successor positions are strictly increasing.)
        for succ in reversed(succs):
            if len(self.history) - succ >= k:
                return self.history[succ:succ + k]
        return self.history[succs[-1]:succs[-1] + k]
