"""Typed serving-engine configuration: the reference's ``EngineConfig``
(``repro/engine_config.py``) as far as the port carries it, plus
``device``: the dense fields, burst admission (``group_prefill``: a
whole-batch ``prefill`` program), ``paging`` (:class:`PagingConfig`, the
paged KV arena of :mod:`repro_torch.core.paging`), ``prefix``
(:class:`PrefixConfig`, cross-request prefix sharing over that arena),
``spec`` (:class:`SpecConfig`, speculative decoding) and ``horizon``
(:class:`HorizonConfig`, fused decode horizons).

Sharding is not ported yet (ROADMAP Queue 1 item 13); the config has no
field for it, so asking for one fails at construction.
``group_prefill`` with ``paging`` or ``spec`` raises as in the reference,
which cannot combine them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class PagingConfig:
    """Paged KV-cache arena geometry (repro_torch.core.paging).

    kv_block: tokens per physical KV block (must divide ``max_len``).
    arena_blocks: device-resident physical blocks; ``None`` fits the whole
        batch (``batch * max_len / kv_block`` — no memory pressure).
    timeslice: optional preemptive round-robin — active requests that have
        decoded this many tokens since (re)admission are preempted when a
        queued request cannot fit the arena.  Host-side policy only.
    """
    kv_block: int = 8
    arena_blocks: Optional[int] = None
    timeslice: Optional[int] = None

    def __post_init__(self):
        if self.kv_block < 1:
            raise ValueError(f"kv_block must be >= 1: {self.kv_block}")
        if self.arena_blocks is not None and self.arena_blocks < 1:
            raise ValueError(f"arena_blocks must be >= 1: "
                             f"{self.arena_blocks}")
        if self.timeslice is not None and self.timeslice < 1:
            raise ValueError(f"timeslice must be >= 1: {self.timeslice}")

    def resolved_arena_blocks(self, batch: int, max_len: int) -> int:
        assert max_len % self.kv_block == 0, (max_len, self.kv_block)
        return (self.arena_blocks if self.arena_blocks is not None
                else batch * (max_len // self.kv_block))


@dataclass(frozen=True)
class PrefixConfig:
    """Cross-request prefix sharing over the paged KV arena
    (repro_torch.core.paging trie + PrefixStore).  Requires ``paging``.

    max_suffix: static suffix capacity of the ``prefill_offset`` program,
        the most tokens recomputed past a matched prefix on the warm
        admission path; ``None`` -> ``2 * kv_block`` (the worst-case
        remainder of a prompt whose whole head matched).  Longer
        divergences fall back to the full prefill program: its storage is
        still deduplicated (matched blocks map read-only; the block-table
        write guard drops the recomputed duplicates), only the compute
        saving is lost.
    min_blocks: smallest trie match worth taking the warm path for;
        below it the full prefill runs (shared mappings still apply).
    """
    max_suffix: Optional[int] = None
    min_blocks: int = 1

    def __post_init__(self):
        if self.max_suffix is not None and self.max_suffix < 1:
            raise ValueError(f"max_suffix must be >= 1: {self.max_suffix}")
        if self.min_blocks < 1:
            raise ValueError(f"min_blocks must be >= 1: {self.min_blocks}")


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding: ``k`` drafts per verify execution, proposed by
    a suffix ``ngram`` prompt-lookup over each request's own history
    (:class:`repro_torch.spec.NGramProposer`)."""
    k: int = 3
    ngram: int = 2

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1: {self.k}")
        if self.ngram < 1:
            raise ValueError(f"spec ngram must be >= 1: {self.ngram}")


@dataclass(frozen=True)
class HorizonConfig:
    """Fused decode horizons: up to ``length`` greedy decode iterations per
    ``decode_horizon`` dispatch.  ``length`` < 2 is plain decode: construct
    no HorizonConfig at all instead."""
    length: int = 4

    def __post_init__(self):
        if self.length < 2:
            raise ValueError(f"horizon length must be >= 2: {self.length}")


@dataclass(frozen=True)
class EngineConfig:
    """Everything a ``ServingEngine`` is, as one frozen value object.

    device: where the engine runs; ``None`` means the card (``"cuda"``).
        Tests ask for ``"cpu"``.
    store_dir: a :class:`~repro_torch.core.program_store.ProgramStore`
        directory the engine boots from and writes back into.
    """
    reduced: bool = True
    batch: int = 4
    max_len: int = 128
    prefill_len: Optional[int] = None     # None -> max_len // 2
    eos_id: Optional[int] = None
    seed: int = 0
    max_queue: int = 64
    clock: str = "wall"                   # "wall" | "step"
    group_prefill: bool = False
    store_dir: Optional[str] = None       # shorthand for ProgramStore(dir)
    device: Optional[str] = None
    paging: Optional[PagingConfig] = None
    prefix: Optional[PrefixConfig] = None
    spec: Optional[SpecConfig] = None
    horizon: Optional[HorizonConfig] = None

    def __post_init__(self):
        if self.clock not in ("wall", "step"):
            raise ValueError(f"clock must be 'wall' or 'step': {self.clock!r}")
        if not 0 < self.resolved_prefill_len < self.max_len:
            raise ValueError(f"need 0 < prefill_len < max_len: "
                             f"{self.prefill_len}, {self.max_len}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1: {self.batch}")
        if self.paging is not None:
            if self.max_len % self.paging.kv_block:
                raise ValueError(f"kv_block must divide max_len: "
                                 f"{self.paging.kv_block}, {self.max_len}")
            if self.group_prefill:
                raise ValueError("group_prefill rewrites every slot; "
                                 "incompatible with paging")
        if self.prefix is not None:
            if self.paging is None:
                raise ValueError("prefix sharing indexes paged KV blocks: "
                                 "set paging too")
            if self.resolved_prefix_suffix > self.resolved_prefill_len:
                raise ValueError(
                    f"prefix max_suffix exceeds prefill_len: "
                    f"{self.resolved_prefix_suffix}, "
                    f"{self.resolved_prefill_len}")
        if self.spec is not None and self.group_prefill:
            raise ValueError("group_prefill rewrites every slot; "
                             "incompatible with the speculative non-ring "
                             "cache layout")

    @property
    def resolved_prefill_len(self) -> int:
        return self.prefill_len or self.max_len // 2

    @property
    def paged(self) -> bool:
        return self.paging is not None

    @property
    def spec_k(self) -> Optional[int]:
        return self.spec.k if self.spec is not None else None

    @property
    def horizon_length(self) -> Optional[int]:
        return self.horizon.length if self.horizon is not None else None

    @property
    def resolved_prefix_suffix(self) -> int:
        """Static token capacity of the warm-path ``prefill_offset``
        program (see :class:`PrefixConfig`)."""
        assert self.prefix is not None
        return (self.prefix.max_suffix
                if self.prefix.max_suffix is not None
                else 2 * self.paging.kv_block)

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    # -- fingerprint contexts ------------------------------------------------
    def program_context(self) -> str:
        """The program-shape half of this config, as a deterministic string
        folded into every serving ProgramSpec's fingerprint context.

        Includes exactly what changes the programs: batch / cache
        geometry, the paged-arena shape, and the speculative width (which
        flips windowed layers to non-ring buffers).  Excludes host-side
        scheduling (clock, max_queue, seed, group_prefill, timeslice,
        proposer n-gram, store location) so engines differing only in
        policy share store entries; the device is in the store's
        environment key."""
        items = [("batch", self.batch), ("max_len", self.max_len),
                 ("prefill_len", self.resolved_prefill_len)]
        if self.paging is not None:
            items += [("paged", True), ("kv_block", self.paging.kv_block),
                      ("arena_blocks", self.paging.resolved_arena_blocks(
                          self.batch, self.max_len))]
        if self.spec is not None:
            items += [("spec", self.spec.k)]
        return repr(tuple(items))

    def horizon_context(self) -> str:
        """Extra context for the ``decode_horizon`` program only: its
        closure-captured statics (H, eos), so two horizon lengths never
        collide."""
        return repr((("horizon", self.horizon_length),
                     ("eos", self.eos_id)))

    def prefix_context(self) -> str:
        """Extra context for the ``prefill_offset`` program only: its
        closure-captured suffix capacity."""
        return repr((("prefix_suffix", self.resolved_prefix_suffix),))
