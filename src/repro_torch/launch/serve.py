"""Continuous-batching serving engine on the persistent executor
(port of the dense and paged paths of ``repro/launch/serve.py``).

The Syscore boots once and hot-loads the ``prefill_slot`` and ``decode``
programs, bound to the engine's parameters and caches (on the card, each
is captured as a CUDA graph there); admission of a new request into a
running batch is a re-execution of ``prefill_slot``, and every engine step
re-executes ``decode`` for all slots at their own positions.  The host
writes each call's tokens into a pinned buffer, and reads back only the
first token's logits of an admission and each step's next tokens.
Finished slots are refilled from a bounded arrival-time queue between
decode steps.  Engine telemetry (TTFT, decode latency, occupancy) goes
through the numbered hostcall table.

Exactness: admission is per slot (a batch-1 prefill copied into the live
cache), K2 and K3 sum in a fixed order whatever the number of rows, and
the MoE routing and combine work row by row, so every request's greedy
stream equals a batch-of-1 decode of the same prompt
(:meth:`ServingEngine.reference_generate`), on the CPU and on the card.
For MoE archs this holds while no decode step drops a token: a batch of at
most 4 keeps the decode capacity at its floor of 4, as in the reference.

Fused decode horizons (``EngineConfig(horizon=HorizonConfig(length=H))``):
a ``decode_horizon`` program runs up to H greedy steps in one replay, the
greedy token fed back and each slot's EOS or budget masked on the device;
the host reads one event buffer back per horizon.  An adaptive policy
(:meth:`ServingEngine._use_horizon`) shrinks to single steps while a
waiting request could be admitted mid-horizon.

Speculative decoding (``EngineConfig(spec=SpecConfig(k=...))``): each
request keeps an n-gram prompt-lookup proposer
(:class:`repro_torch.spec.NGramProposer`); a ``verify`` program scores
every slot's last token and up to k drafts in one replay, accepts the
longest greedy-matching prefix and rolls the rest back, so the stream is
the non-speculative one.  A step with no proposal anywhere falls back to
a horizon, when one is loaded, or to plain decode.

Paged KV (``EngineConfig(paging=PagingConfig(...))``): attention caches
live in a capacity-bounded block arena managed by
:class:`~repro_torch.core.paging.PagedKVManager`, so the batch's KV
footprint may exceed the arena.  Admission waits until the queue head's
blocks fit, optionally preempting slots that used up their timeslice;
a preempted request's blocks stay resident until LRU pressure swaps them
out to the host tier, and its resume maps them back (a hit) or copies
them back (a page fault).  Every pager edit happens between replays, in
place on the tree the programs are bound to.  Page faults and arena
occupancy are hostcall metrics 6 and 7.

Prefix sharing (``EngineConfig(prefix=PrefixConfig(...))``, on the paged
arena): the pager keeps a trie of published prompt blocks, backed by a
:class:`~repro_torch.core.paging.PrefixStore` on the host.  A request
whose prompt matches published blocks maps them read-only into its row.
An attention-only, non-MoE arch (qwen3 among the ported ones) then runs
only the suffix, through the ``prefill_offset`` program (the warm path);
the others run a full ``prefill_slot`` whose writes into the shared
blocks drop (tier 2: memory shared, compute not).  A cold or tier-2
admission publishes its full prompt blocks.  Matched tokens per prefix
admission are hostcall metric 10.

Burst admission (``EngineConfig(group_prefill=True)``, dense caches only):
when the batch is idle and two or more requests are due, one execution of
the whole-batch ``prefill`` program admits up to ``batch`` of them.

The engine runs on the card unless asked otherwise: ``device=None`` means
``"cuda"``, and a missing card is an error, never a quiet move to the CPU.
"""
from __future__ import annotations

import argparse
import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import steps as steps_lib
from repro_torch.core.hostcall import CALL_BATCH, CALL_METRIC, CALL_STEP_REPORT
from repro_torch.core.program_store import ProgramStore
from repro_torch.core.syscore import (METRIC_KERNEL_BUILD_MS,
                                      METRIC_PROGRAM_COMPILE_MS,
                                      METRIC_PROGRAM_LOAD_MS, Preloaded,
                                      Syscore)
from repro_torch.core.paging import PagedKVManager, PrefixStore
from repro_torch.engine_config import (EngineConfig, HorizonConfig,
                                       PagingConfig, PrefixConfig,
                                       SpecConfig)
from repro_torch.kernels import _build
from repro_torch.models import registry, transformer
from repro_torch.spec import NGramProposer

# CALL_METRIC name codes used by the engine (the reference's schema)
METRIC_TTFT_MS = 1        # time-to-first-token per request, ms
METRIC_DECODE_MS = 2      # per decode-step wall latency, ms
METRIC_OCCUPANCY = 3      # active slots / batch, per decode step
# codes 4/5 are program-lifecycle telemetry and 11 the kernel build
# (repro_torch.core.syscore)
METRIC_PAGE_FAULT = 6     # paged KV swap-in copied blocks from host (value
                          # = blocks moved), per fault
METRIC_ARENA_OCCUPANCY = 7  # resident arena blocks / capacity, per decode step
METRIC_SPEC_ACCEPT = 8    # accepted / proposed draft tokens, per verify step
METRIC_HORIZON_TOKENS = 9  # tokens emitted per fused decode-horizon dispatch
METRIC_PREFIX_HIT = 10    # prompt tokens served from shared prefix blocks
                          # (value = matched tokens), per prefix admission


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S_p,) int32
    max_new: int = 16
    arrival_time: float = 0.0        # engine-clock time at which it may start
    generated: List[int] = field(default_factory=list)
    done: bool = False
    prompt_len: int = 0
    slot: int = -1
    t_submit: float = 0.0            # wall-clock timestamps
    t_first: Optional[float] = None  # None until the request is placed
    t_done: Optional[float] = None   # None until it finishes
    needs_resume: bool = False       # preempted: KV lives in the pager, not
                                     # a slot; re-admission swaps in instead
                                     # of prefilling
    gen_at_admit: int = 0            # len(generated) at last (re)admission

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token; ``None`` for a request never placed."""
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-done wall latency; ``None`` until finished."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` is the card.  A CUDA device without a card raises."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the serving engine runs on the card by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def _zero(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            _zero(v)
    else:
        tree.zero_()


class ServingEngine:
    """Continuous-batching engine over hot-loaded programs.

    ``params``: a parameter tree already on ``device`` (e.g. from
    :func:`repro_torch.bridge.params_from_numpy`), else ``config.seed``
    draws one.  ``device`` overrides ``config.device``; both ``None`` means
    ``"cuda"``.  ``prefix_store``: with ``config.prefix``, a
    :class:`~repro_torch.core.paging.PrefixStore` to share (an engine
    booted on a store another engine published into serves its prefixes
    warm); ``None`` makes one of the engine's own.  ``store``: a
    :class:`~repro_torch.core.program_store.ProgramStore` ("global
    memory"; ``config.store_dir`` is shorthand for one): a warm boot
    installs every program from its export, without calling the program
    functions (on the card each is still warmed up and captured), and a
    cold boot exports every program into it.  ``preloaded``: stored
    programs already read and loaded off the card
    (:func:`repro_torch.core.syscore.preload`, a fleet's background
    boot), installed in place of a store read.  ``fault_hook``: called
    with the engine's step count at the top of every :meth:`tick`; raising
    :class:`repro_torch.runtime.fault.SimulatedFailure` models this
    replica crashing mid-serving (:mod:`repro_torch.cluster`).
    """

    def __init__(self, arch: str, config: Optional[EngineConfig] = None, *,
                 params=None, device: Optional[str] = None,
                 store: Optional[ProgramStore] = None,
                 prefix_store: Optional[PrefixStore] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 preloaded: Optional[Dict[str, Preloaded]] = None):
        config = config if config is not None else EngineConfig()
        self.device = resolve_device(device or config.device)
        self.config = config.replace(device=str(self.device))
        self.arch = arch
        self.fault_hook = fault_hook
        self.reduced = config.reduced
        self.cfg = registry.get_config(arch, reduced=config.reduced)
        if self.cfg.is_encdec:
            # as the reference's engine (repro/launch/serve.py) asserts
            raise ValueError(
                f"{arch} is an encoder-decoder model and this serving "
                f"engine is decoder-only; its prefill and decode programs "
                f"are repro_torch.steps.encdec_program_specs")
        transformer.check_supported(self.cfg)
        self.batch = config.batch
        self.max_len = config.max_len
        self.prefill_len = config.resolved_prefill_len
        self.eos_id = config.eos_id
        self.max_queue = config.max_queue
        self.clock = config.clock
        self.group_prefill = config.group_prefill
        self.paged = config.paged
        self.timeslice = config.paging.timeslice if self.paged else None
        self.spec_k = config.spec_k
        self.spec_ngram = config.spec.ngram if config.spec is not None else 2
        self.horizon = config.horizon_length
        self.prefix_cfg = config.prefix
        self.prefix_store = None
        self.prefix_suffix = (config.resolved_prefix_suffix
                              if config.prefix is not None else 0)
        self._prefix_tier1 = (config.prefix is not None and
                              steps_lib.warm_prefix_capable(self.cfg))
        if store is None and config.store_dir is not None:
            store = ProgramStore(config.store_dir)
        self.syscore = Syscore(self.device, store=store, preloaded=preloaded)
        on_card = self.device.type == "cuda"
        if on_card:
            # the kernels are built (or found current) once per process
            t0 = time.perf_counter()
            _build.library()
            self.syscore.hostcalls.dispatch(
                CALL_METRIC, METRIC_KERNEL_BUILD_MS,
                1e3 * (time.perf_counter() - t0))
        self.params = params if params is not None else \
            transformer.init_params(self.cfg, config.seed, device=self.device)
        # the programs are bound to these trees: allocated before hot_load
        if self.paged:
            self.kv_block = config.paging.kv_block
            self.blocks_per_slot = self.max_len // self.kv_block
            self.arena_blocks = config.paging.resolved_arena_blocks(
                self.batch, self.max_len)
            self.caches = transformer.init_paged_cache(
                self.cfg, self.batch, self.max_len, kv_block=self.kv_block,
                arena_blocks=self.arena_blocks, device=self.device)
            if self.prefix_cfg is not None:
                self.prefix_store = (prefix_store if prefix_store is not None
                                     else PrefixStore())
            self.pager = PagedKVManager(
                self.arena_blocks,
                transformer.paged_block_bytes(self.cfg, self.kv_block),
                uva=self.syscore.uva, kv_block=self.kv_block,
                prefix_store=self.prefix_store,
                on_fault=lambda blocks: self.syscore.hostcalls.dispatch(
                    CALL_METRIC, METRIC_PAGE_FAULT, float(blocks)))
        else:
            # the speculative engine's windowed buffers are flat: rollback
            # restores rejected writes at absolute slots
            self.caches = transformer.init_cache(self.cfg, self.batch,
                                                 self.max_len,
                                                 ring=self.spec_k is None,
                                                 device=self.device)
        self._prompt = torch.zeros((1, self.prefill_len), dtype=torch.int32,
                                   pin_memory=on_card)
        self._last_tokens = torch.zeros((self.batch, 1), dtype=torch.int32,
                                        pin_memory=on_card)
        if self.spec_k is not None:
            self._drafts = torch.zeros((self.batch, self.spec_k + 1),
                                       dtype=torch.int32, pin_memory=on_card)
        if self.horizon is not None:
            self._budget = torch.zeros((self.batch,), dtype=torch.int32,
                                       pin_memory=on_card)
        if self._prefix_tier1:
            self._suffix = torch.zeros((1, self.prefix_suffix),
                                       dtype=torch.int32, pin_memory=on_card)
        if self.group_prefill:
            self._burst = torch.zeros((self.batch, self.prefill_len),
                                      dtype=torch.int32, pin_memory=on_card)
            self._burst_lengths = torch.zeros((self.batch,),
                                              dtype=torch.int32,
                                              pin_memory=on_card)

        specs = steps_lib.serve_program_specs(self.cfg, self.config,
                                              self.params, self.caches)
        self.programs = {name: self.syscore.hot_load(spec)
                         for name, spec in specs.items()}
        self._prefill = self.programs.get("prefill")
        self._prefill_slot = self.programs["prefill_slot"]
        self._prefill_offset = self.programs.get("prefill_offset")
        self._decode = self.programs["decode"]
        self._verify = self.programs.get("verify")
        self._decode_horizon = self.programs.get("decode_horizon")
        # the card's warm-ups wrote the caches: boot them empty again (a
        # paged tree's block table unmapped, -1: 0 would map every slot to
        # physical block 0)
        _zero(self.caches)
        if self.paged:
            self.caches["block_table"].fill_(-1)

        self.slots: List[Optional[Request]] = [None] * self.batch
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.steps = 0                 # engine iterations (incl. idle ticks)
        self.decode_steps = 0          # decode-program dispatches
        self.decode_tokens = 0         # tokens emitted by the decode path
        self.horizon_steps = 0         # decode_horizon executions
        self.horizon_tokens = 0        # tokens emitted by fused horizons
        self.spec_steps = 0            # verify executions
        self.draft_tokens = 0          # drafts proposed
        self.accepted_drafts = 0       # drafts accepted
        self._proposers: Dict[int, NGramProposer] = {}
        self.admitted = 0
        self.rejected = 0
        self.refill_admissions = 0     # admissions while other slots active
        self.preemptions = 0
        self.swap_ins = 0
        self.prefix_admissions = 0     # admissions that mapped shared blocks
        self.warm_admissions = 0       # of those, through prefill_offset
        self.prefix_tokens_reused = 0  # prompt tokens never re-prefilled
        self._n_submitted = 0
        self.draining = False          # quiescing: no new admissions, the
                                       # in-flight batch runs to completion
        self._t0 = time.perf_counter()

    # -- clock ----------------------------------------------------------------
    def now(self) -> float:
        if self.clock == "step":
            return float(self.steps)
        return time.perf_counter() - self._t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request management ---------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               arrival_time: float = 0.0,
               rid: Optional[int] = None) -> Optional[Request]:
        """Enqueue a request; None if the bounded admission queue is full
        or the engine is draining.

        ``rid`` pins the request id instead of taking the next engine-local
        one: a cluster router assigns global ids, so a request keeps its
        identity across replicas and failover replays (the internal
        counter advances past any pinned id)."""
        if self.draining or len(self.queue) >= self.max_queue:
            self.rejected += 1
            return None
        prompt = np.asarray(prompt, np.int32)[-self.prefill_len:]
        max_new = min(max_new, self.max_len - len(prompt))
        if self.paged and self._blocks_needed(len(prompt), max_new) > \
                self.arena_blocks:
            self.rejected += 1       # can never fit the arena, even alone
            return None
        if rid is None:
            rid = self._n_submitted
        req = Request(rid=int(rid), prompt=prompt, max_new=max_new,
                      arrival_time=arrival_time, prompt_len=len(prompt),
                      t_submit=time.perf_counter())
        self._n_submitted = max(self._n_submitted, int(rid) + 1)
        bisect.insort(self.queue, req, key=lambda r: (r.arrival_time, r.rid))
        return req

    def _place(self, slot: int, req: Request, last_logits: np.ndarray):
        """Post-prefill bookkeeping of an admission."""
        first = int(np.argmax(last_logits[: self.cfg.vocab_size]))
        req.generated.append(first)
        if self.spec_k is not None:
            # one prompt-lookup index per request, fed as tokens append;
            # keyed by rid, so it survives a preempt / resume round trip
            prop = self._proposers[req.rid] = NGramProposer(self.spec_ngram)
            prop.observe(req.prompt.tolist())
            prop.observe([first])
        req.t_first = time.perf_counter()
        req.slot = slot
        req.gen_at_admit = len(req.generated)
        self.slots[slot] = req
        self.admitted += 1
        if any(s is not None and s is not req and len(s.generated) > 1
               for s in self.slots):
            self.refill_admissions += 1
        self.syscore.hostcalls.dispatch(
            CALL_METRIC, METRIC_TTFT_MS, 1e3 * req.ttft_s)
        self._maybe_finish(req)   # max_new == 1 or instant EOS

    def _admit_one(self, slot: int, req: Request):
        """Prefill ``req`` into ``slot`` of the live batch (a re-execution
        of the hot-loaded prefill_slot program).  The pinned prompt buffer
        is rewritten only after the last admission's logits came back, so
        its copy to the card has ended."""
        tokens = self._prompt.numpy()
        tokens[:] = 0
        tokens[0, :req.prompt_len] = req.prompt
        self.caches, last = self._prefill_slot(
            self.params, self.caches, self._prompt, slot, req.prompt_len)
        self._place(slot, req, last.float().cpu().numpy())

    def _admit_offset(self, slot: int, req: Request, offset: int):
        """Warm admission (a prefix hit): the slot's first ``offset``
        prompt tokens are already in shared arena blocks mapped into its
        block-table row, so only the suffix runs, one execution of the
        hot-loaded ``prefill_offset`` program from position ``offset``."""
        suffix = req.prompt[offset:]
        assert 1 <= len(suffix) <= self.prefix_suffix, \
            (req.rid, offset, req.prompt_len)
        tokens = self._suffix.numpy()
        tokens[:] = 0
        tokens[0, :len(suffix)] = suffix
        self.caches, last = self._prefill_offset(
            self.params, self.caches, self._suffix, slot, offset,
            req.prompt_len)
        self._place(slot, req, last.float().cpu().numpy())

    def _admit_burst(self, reqs: List[Request]):
        """Cold-start burst: admit every request in ONE execution of the
        whole-batch ``prefill`` program (the engine is idle: the program
        rewrites every row; unused rows get a length-1 dummy prompt)."""
        tokens = self._burst.numpy()
        lengths = self._burst_lengths.numpy()
        tokens[:] = 0
        lengths[:] = 1
        for i, req in enumerate(reqs):
            tokens[i, :req.prompt_len] = req.prompt
            lengths[i] = req.prompt_len
        self.caches, last = self._prefill(self.params, self.caches,
                                          self._burst, self._burst_lengths)
        last = last.float().cpu().numpy()     # waits for the device result
        for i, req in enumerate(reqs):
            self._place(i, req, last[i])

    def _admit(self):
        """Refill free slots from the queue, earliest arrival first; an
        idle ``group_prefill`` engine admits a due burst in one
        execution."""
        t = self.now()
        if self.paged:
            self._admit_paged(t)
            return
        eligible = sum(1 for r in self.queue if r.arrival_time <= t)
        if (self.group_prefill and eligible >= 2
                and not any(s is not None for s in self.slots)):
            self._admit_burst([self.queue.pop(0)
                               for _ in range(min(eligible, self.batch))])
            return
        for i, s in enumerate(self.slots):
            if s is not None:
                continue
            if not self.queue or self.queue[0].arrival_time > t:
                break
            self._admit_one(i, self.queue.pop(0))

    # -- paged admission / preemption -----------------------------------------
    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.kv_block)

    def _admit_paged(self, t: float):
        """FIFO admission under memory pressure: the queue head admits only
        when its block reservation can be made resident without touching a
        pinned (actively decoding) page; otherwise it waits — optionally
        rotating out slots that have used up their timeslice first.  With
        prefix sharing a fresh request maps its prompt's published blocks
        read-only; an attention-only arch then runs only the suffix when
        it fits ``prefill_offset`` (the warm path), else the full
        ``prefill_slot`` runs over the shared mappings (tier 2).  A cold
        or tier-2 admission publishes its full prompt blocks."""
        for i, s in enumerate(self.slots):
            if s is not None:
                continue
            if not self.queue or self.queue[0].arrival_time > t:
                break
            req = self.queue[0]
            n_blocks = self._blocks_needed(req.prompt_len, req.max_new)
            shared = (self.pager.match_prefix(req.prompt)
                      if self.prefix_cfg is not None and not req.needs_resume
                      else [])
            if not self.pager.can_admit(req.rid, n_blocks, shared=shared):
                if self.timeslice is not None:
                    self._preempt_expired()
                if not self.pager.can_admit(req.rid, n_blocks,
                                            shared=shared):
                    break
            # remove by identity: _preempt_expired may have re-queued a
            # victim AHEAD of the peeked head (same arrival time, smaller
            # rid), so pop(0) could drop the victim and admit ``req`` twice
            for qi, r in enumerate(self.queue):
                if r is req:
                    del self.queue[qi]
                    break
            if req.needs_resume:
                self._resume_one(i, req)
                continue
            self.caches = self.pager.admit(req.rid, n_blocks, i, self.caches,
                                           shared=shared)
            matched = len(shared) * self.kv_block
            warm = bool(shared) and self._prefix_tier1 and \
                len(shared) >= self.prefix_cfg.min_blocks and \
                req.prompt_len - matched <= self.prefix_suffix
            if warm:
                self._admit_offset(i, req, matched)
            else:
                self._admit_one(i, req)
            if shared:
                self.prefix_admissions += 1
                self.warm_admissions += warm
                self.prefix_tokens_reused += matched
                self.syscore.hostcalls.dispatch(
                    CALL_METRIC, METRIC_PREFIX_HIT, float(matched))
            # publish only full-prefill blocks: the cold path's bytes are
            # the ones every later consumer (warm or tier 2) reproduces.
            # Skipped when the request already finished in its admission
            # (its blocks went back to the free list with it)
            if self.prefix_cfg is not None and not warm \
                    and req.rid in self.pager.pages:
                self.caches = self.pager.publish(req.rid, req.prompt, i,
                                                 self.caches)

    def _resume_one(self, slot: int, req: Request):
        """Swap a preempted request back into a slot: the pager restores
        its blocks (a hit if still resident, a page fault if they were
        written back to host) and its recurrent rows; decode then resumes
        from the exact position it left off, so the token stream is
        unchanged by the round trip."""
        self.caches = self.pager.resume(req.rid, slot, self.caches)
        self.caches["pos"][slot] = req.prompt_len + len(req.generated) - 1
        req.slot = slot
        req.needs_resume = False
        req.gen_at_admit = len(req.generated)
        self.slots[slot] = req
        self.swap_ins += 1

    def preempt(self, req: Request, requeue_at: Optional[float] = None):
        """Swap an active request out of its slot and back into the queue.
        Its recurrent rows copy to host eagerly (the slot is reused); its
        KV blocks stay arena-resident, unpinned, until LRU pressure writes
        them back — a prompt resume costs nothing.  ``requeue_at`` moves
        the request behind current waiters (round-robin rotation); the
        default keeps its original arrival time (resume ASAP)."""
        assert self.paged and req.slot >= 0 and not req.done
        self.caches = self.pager.preempt(req.rid, req.slot, self.caches)
        self.slots[req.slot] = None
        req.slot = -1
        req.needs_resume = True
        if requeue_at is not None:
            req.arrival_time = requeue_at
        bisect.insort(self.queue, req, key=lambda r: (r.arrival_time, r.rid))
        self.preemptions += 1

    def _preempt_expired(self):
        for req in list(self.slots):
            if req is not None and \
                    len(req.generated) - req.gen_at_admit >= self.timeslice:
                self.preempt(req, requeue_at=self.now())

    def _maybe_finish(self, req: Request):
        hit_eos = self.eos_id is not None and req.generated and \
            req.generated[-1] == self.eos_id
        full = req.prompt_len + len(req.generated) >= self.max_len
        if len(req.generated) >= req.max_new or hit_eos or full:
            req.done = True
            req.t_done = time.perf_counter()
            self._proposers.pop(req.rid, None)
            self.completed.append(req)
            if self.paged and req.rid in self.pager.pages:
                # the request is done, so its blocks free instead of
                # swapping; release() also handles a request finishing
                # while preempted (slot -1) without touching a live row
                self.caches = self.pager.release(req.rid, req.slot,
                                                 self.caches)
            if req.slot >= 0:
                self.slots[req.slot] = None

    def _step_metrics(self, dt: float, occupancy: float, extra=()):
        """ONE aggregated hostcall round trip per engine step (CALL_BATCH):
        decode latency, occupancy, the ``extra`` calls and the step
        report."""
        calls = [(CALL_METRIC, METRIC_DECODE_MS, 1e3 * dt),
                 (CALL_METRIC, METRIC_OCCUPANCY, occupancy)]
        calls.extend(extra)
        if self.paged:
            calls.append((CALL_METRIC, METRIC_ARENA_OCCUPANCY,
                          self.pager.arena_occupancy()))
        calls.append((CALL_STEP_REPORT, self.decode_steps, dt,
                      time.perf_counter()))
        self.syscore.hostcalls.dispatch(CALL_BATCH, calls)

    def _decode_once(self):
        tokens = self._last_tokens.numpy()
        tokens[:] = 0
        for i, req in enumerate(self.slots):
            if req is not None:
                tokens[i, 0] = req.generated[-1]
        active = sum(s is not None for s in self.slots)
        t1 = time.perf_counter()
        self.caches, next_tok, _ = self._decode(
            self.params, self.caches, self._last_tokens)
        nt = next_tok.cpu().numpy()       # waits for the device result
        dt = time.perf_counter() - t1
        self.decode_steps += 1
        self.decode_tokens += active
        self._step_metrics(dt, active / self.batch)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(int(nt[i, 0]))
            if req.rid in self._proposers:
                self._proposers[req.rid].observe(req.generated[-1:])
            self._maybe_finish(req)
        return dt

    def _verify_once(self):
        """One speculative iteration: up to ``spec_k`` drafts per active
        slot from its request's proposer, scored in one replay of
        ``verify``, each row keeping its longest greedy-matching prefix.
        A row with fewer proposals is padded with its last token (an
        accepted token is always the model's own, so the padding is
        exact).  With no proposal in any slot, the step falls back to
        :meth:`_advance_decode`."""
        k = self.spec_k
        tokens = self._drafts.numpy()
        tokens[:] = 0
        n_props = np.zeros((self.batch,), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tokens[i, :] = req.generated[-1]
            props = self._proposers[req.rid].propose(k)
            n_props[i] = len(props)
            tokens[i, 1:1 + len(props)] = props
        drafted = int(n_props.sum())
        if drafted == 0:
            self._advance_decode()
            return
        active = sum(s is not None for s in self.slots)
        if self.paged:
            # speculative over-allocation: map blocks so that draft writes
            # past the base reservation land somewhere real (from the free
            # list only; a failed grow drops the overshoot into the sink)
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                pos0 = req.prompt_len + len(req.generated) - 1
                need = min(-(-(pos0 + k + 1) // self.kv_block),
                           self.blocks_per_slot)
                self.caches = self.pager.grow(req.rid, need, i, self.caches)
        t1 = time.perf_counter()
        self.caches, ys, n_new = self._verify(self.params, self.caches,
                                              self._drafts)
        ys = ys.cpu().numpy()               # waits for the device result
        n_new = n_new.cpu().numpy()
        dt = time.perf_counter() - t1
        self.decode_steps += 1
        self.spec_steps += 1
        accepted = 0
        toks0 = self.decode_tokens
        for i, req in enumerate(list(self.slots)):
            if req is None:
                continue
            used = 0
            for j in range(int(n_new[i])):
                if req.done:
                    break                   # EOS or budget inside the accept
                req.generated.append(int(ys[i, j]))
                used += 1
                self._maybe_finish(req)
            self.decode_tokens += used
            accepted += min(used - 1, int(n_props[i]))
            if req.rid in self._proposers:
                self._proposers[req.rid].observe(req.generated[-used:])
            if self.paged and req.rid in self.pager.pages and req.slot >= 0:
                # reclaim on rejection: the speculative tail goes back to
                # the free list (verify restored its bytes in the program)
                self.caches = self.pager.trim_to_base(req.rid, i,
                                                      self.caches)
        self.draft_tokens += drafted
        self.accepted_drafts += accepted
        self._step_metrics(dt, active / self.batch,
                           extra=[(CALL_METRIC, METRIC_SPEC_ACCEPT,
                                   accepted / drafted)])
        return dt

    # -- fused decode horizons ------------------------------------------------
    def _budget_left(self, req: Request) -> int:
        """Tokens ``req`` may still emit (max_new and cache-length caps)."""
        return min(req.max_new,
                   self.max_len - req.prompt_len) - len(req.generated)

    def _use_horizon(self) -> bool:
        """Adaptive horizon policy: fuse only when it cannot hurt latency.

        While an eligible request waits, a slot freed mid-horizon would
        leave it stuck behind the fused dispatch, so the engine shrinks to
        single steps, unless no admission is possible for the whole
        horizon: every slot holds a request that cannot finish inside it,
        which is known exactly when finishes come only from budgets (no
        EOS) and no timeslice preemption can rotate a slot out.  A
        saturated engine with a backed-up queue therefore still fuses.
        Fusing also needs a row able to use a good part of the horizon: a
        short tail (every remaining budget < H/2) runs as single steps."""
        if self._decode_horizon is None:
            return False
        if self.queue and self.queue[0].arrival_time <= self.now():
            if self.eos_id is not None or self.timeslice is not None:
                return False
            if not all(s is not None and self._budget_left(s) > self.horizon
                       for s in self.slots):
                return False
        return any(s is not None and
                   self._budget_left(s) >= max(2, self.horizon // 2)
                   for s in self.slots)

    def _advance_decode(self):
        """One decode-path advance: a fused horizon when the adaptive
        policy allows it, else a single decode step."""
        if self._use_horizon():
            self._decode_horizon_once()
        else:
            self._decode_once()

    def _decode_horizon_once(self):
        """One fused horizon: up to ``self.horizon`` decode steps in one
        replay.  The host crosses the boundary once: the event buffer
        (emitted tokens, per-slot counts, occupancy) comes back in one
        transfer, and all bookkeeping (appends, EOS and budget finishes,
        paged release, proposer feed, metrics) happens here."""
        tokens = self._last_tokens.numpy()
        budget = self._budget.numpy()
        tokens[:] = 0
        budget[:] = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tokens[i, 0] = req.generated[-1]
            budget[i] = min(self._budget_left(req), self.horizon)
        t1 = time.perf_counter()
        self.caches, events = self._decode_horizon(
            self.params, self.caches, self._last_tokens, self._budget)
        buf = events["buffer"].cpu().numpy()   # waits for the device result
        dt = time.perf_counter() - t1
        b, h = self.batch, self.horizon
        toks = buf[:b * h].reshape(b, h)
        n_emit = buf[b * h:b * h + b]
        occ = buf[b * h + b:].view(np.float32)
        emitted = int(n_emit.sum())
        self.decode_steps += 1
        self.horizon_steps += 1
        self.decode_tokens += emitted
        self.horizon_tokens += emitted
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            new = [int(t) for t in toks[i, :n_emit[i]]]
            req.generated.extend(new)
            if new and req.rid in self._proposers:
                self._proposers[req.rid].observe(new)
            self._maybe_finish(req)
        # one METRIC_OCCUPANCY entry per in-graph step that ran a live row,
        # so run()'s occupancy mean stays weighted per decode step when
        # fused and single steps mix
        ran = [float(o) for o in occ if o > 0]
        extra = [(CALL_METRIC, METRIC_OCCUPANCY, o) for o in ran[1:]]
        extra.append((CALL_METRIC, METRIC_HORIZON_TOKENS, float(emitted)))
        self._step_metrics(dt, ran[0] if ran else 0.0, extra=extra)
        return dt

    @property
    def has_work(self) -> bool:
        """True while any request is queued or occupies a slot."""
        return bool(self.queue) or any(s is not None for s in self.slots)

    def begin_drain(self):
        """Enter drain mode: every later :meth:`submit` is refused while
        already-accepted work, queued and in flight, runs to completion
        (the quiesce half of an elastic shrink)."""
        self.draining = True

    def withdraw(self, rid: int) -> Optional[Request]:
        """Remove and return a QUEUED request by id, or ``None`` if it is
        in a slot, preempted (its KV lives in the pager) or unknown.  A
        withdrawn request holds no engine state, so resubmitting its
        prompt elsewhere is exact (elastic rebalancing)."""
        for qi, r in enumerate(self.queue):
            if r.rid == rid and not r.needs_resume:
                return self.queue.pop(qi)
        return None

    def tick(self) -> bool:
        """One supervised engine iteration (the step-level API a cluster
        supervisor drives): the fault hook fires first, then one
        :meth:`step`."""
        if self.fault_hook is not None:
            self.fault_hook(self.steps)
        return self.step()

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time load view for a router or supervisor, host
        bookkeeping only (no device sync)."""
        active = [s for s in self.slots if s is not None]
        return {
            "steps": self.steps,
            "batch": self.batch,
            "active": len(active),
            "queue_depth": len(self.queue),
            "max_queue": self.max_queue,
            "inflight_rids": sorted([r.rid for r in active] +
                                    [r.rid for r in self.queue]),
            "completed": len(self.completed),
            "draining": self.draining,
            "arena_occupancy": (self.pager.arena_occupancy()
                                if self.paged else 0.0),
        }

    def step(self) -> bool:
        """One engine iteration: admit into free slots, then one decode
        advance for every active slot: a speculative verify, a fused
        horizon or a single decode step.  Returns False when no work
        remains."""
        if not self.has_work:
            return False
        self._admit()
        if any(s is not None for s in self.slots):
            if self.spec_k is not None:
                self._verify_once()
            else:
                self._advance_decode()
        elif self.clock == "wall" and self.queue:
            wait = self.queue[0].arrival_time - self.now()
            time.sleep(min(max(wait, 1e-4), 1e-2))
        self.steps += 1
        return True

    def run(self, max_steps: int = 10_000) -> Dict[str, float]:
        """Serve until the queue and slots drain (or ``max_steps`` engine
        iterations pass).  Counters and metric windows are relative to this
        call."""
        metrics = self.syscore.hostcalls.metrics
        start_steps, done0 = self.steps, len(self.completed)
        n_dec0 = len(metrics.get(METRIC_DECODE_MS, []))
        n_ttft0 = len(metrics.get(METRIC_TTFT_MS, []))
        n_occ0 = len(metrics.get(METRIC_OCCUPANCY, []))
        n_arena0 = len(metrics.get(METRIC_ARENA_OCCUPANCY, []))
        dec_steps0, dec_toks0 = self.decode_steps, self.decode_tokens
        hor0, hor_toks0 = self.horizon_steps, self.horizon_tokens
        spec0, drf0, acc0 = (self.spec_steps, self.draft_tokens,
                             self.accepted_drafts)
        adm0, ref0 = self.admitted, self.refill_admissions
        pre0, swi0 = self.preemptions, self.swap_ins
        pa0, wa0 = self.prefix_admissions, self.warm_admissions
        ptr0 = self.prefix_tokens_reused
        pf0 = self.pager.page_faults if self.paged else 0
        swo0 = self.pager.swap_outs if self.paged else 0
        self._sync()
        t0 = time.perf_counter()
        while self.steps - start_steps < max_steps and self.step():
            pass
        self._sync()
        wall = time.perf_counter() - t0
        completed = self.completed[done0:]
        toks = sum(len(r.generated) for r in completed)
        decode_ms = sorted(metrics.get(METRIC_DECODE_MS, [])[n_dec0:])
        ttft_ms = metrics.get(METRIC_TTFT_MS, [])[n_ttft0:]
        occ = metrics.get(METRIC_OCCUPANCY, [])[n_occ0:]
        dec_toks = self.decode_tokens - dec_toks0
        stats = {
            "requests": len(completed),
            "tokens": toks,
            "wall_s": wall,
            "tok_per_s": toks / wall if wall else 0.0,
            "decode_p50_ms": (decode_ms[len(decode_ms) // 2]
                              if decode_ms else None),
            "ttft_ms": (sum(ttft_ms) / len(ttft_ms) if ttft_ms else None),
            "occupancy": sum(occ) / max(len(occ), 1),
            "decode_steps": self.decode_steps - dec_steps0,
            "decode_tokens": dec_toks,
            # decode-path dispatches per generated token, the number a
            # fused horizon drives toward 1/H
            "dispatches_per_token": (self.decode_steps - dec_steps0)
                                    / max(dec_toks, 1),
            "admitted": self.admitted - adm0,
            "rejected": self.rejected,
            "refill_admissions": self.refill_admissions - ref0,
        }
        if self._decode_horizon is not None:
            stats.update({
                "horizon_steps": self.horizon_steps - hor0,
                "horizon_tokens": self.horizon_tokens - hor_toks0,
            })
        if self.spec_k is not None:
            drafted = self.draft_tokens - drf0
            accepted = self.accepted_drafts - acc0
            stats.update({
                "spec_steps": self.spec_steps - spec0,
                "draft_tokens": drafted,
                "accepted_drafts": accepted,
                "accept_rate": accepted / max(drafted, 1),
            })
        if self.paged:
            arena = metrics.get(METRIC_ARENA_OCCUPANCY, [])[n_arena0:]
            stats.update({
                "preemptions": self.preemptions - pre0,
                "swap_ins": self.swap_ins - swi0,
                "page_faults": self.pager.page_faults - pf0,
                "swap_outs": self.pager.swap_outs - swo0,
                "arena_occupancy": sum(arena) / max(len(arena), 1),
            })
        if self.prefix_cfg is not None:
            stats.update({
                "prefix_admissions": self.prefix_admissions - pa0,
                "warm_admissions": self.warm_admissions - wa0,
                "prefix_tokens_reused": self.prefix_tokens_reused - ptr0,
            })
        return stats

    def drain_completed(self) -> List[Request]:
        """Hand finished requests to the caller and release engine-side
        history (metric channels other than program lifecycle, step
        reports)."""
        done, self.completed = self.completed, []
        hc = self.syscore.hostcalls
        hc.drain_metrics(keep=(METRIC_PROGRAM_COMPILE_MS,
                               METRIC_PROGRAM_LOAD_MS,
                               METRIC_KERNEL_BUILD_MS))
        hc.step_times.clear()
        hc.step_stamps.clear()
        return done

    # -- reference path -------------------------------------------------------
    def reference_generate(self, prompt: np.ndarray, max_new: int) -> List[int]:
        """Batch-of-1 greedy decode of ``prompt`` with this engine's params —
        the oracle each slot's output must match token for token.  The
        reference engine is built once (on the card it captures programs of
        its own) and re-used: admission rewrites its single slot
        completely."""
        ref = getattr(self, "_ref_engine", None)
        if ref is None:
            ref_config = self.config.replace(
                batch=1, prefill_len=self.prefill_len, clock="step",
                group_prefill=False, paging=None, prefix=None, spec=None,
                horizon=None, store_dir=None)
            ref = self._ref_engine = ServingEngine(
                self.arch, ref_config, params=self.params)
        req = ref.submit(prompt, max_new)
        ref.run()
        ref.drain_completed()
        return req.generated


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve random prompts through the port's engine.")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=registry.PORTED_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV-cache arena (repro_torch.core.paging)")
    ap.add_argument("--kv-block", type=int, default=8)
    ap.add_argument("--arena-blocks", type=int, default=None,
                    help="device-resident KV blocks; below "
                         "batch*max_len/kv_block creates memory pressure")
    ap.add_argument("--timeslice", type=int, default=None,
                    help="preempt slots that decoded this many tokens when "
                         "the queue head cannot fit the arena")
    ap.add_argument("--prefix", action="store_true",
                    help="cross-request prefix sharing over the paged "
                         "arena (implies --paged)")
    ap.add_argument("--prefix-max-suffix", type=int, default=None,
                    help="warm-path suffix capacity; None = 2*kv_block")
    ap.add_argument("--group-prefill", action="store_true",
                    help="burst admission: one whole-batch prefill when "
                         "the batch is idle (dense caches only)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="speculative decoding: drafts per verify step "
                         "(n-gram prompt lookup); none = plain decode")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="suffix n-gram length the proposer matches on")
    ap.add_argument("--horizon", type=int, default=None,
                    help="fused decode horizon: up to H decode steps per "
                         "dispatch (none or 1 = one per token)")
    ap.add_argument("--store-dir", default=None,
                    help="persistent program store; a second run with the "
                         "same dir installs the programs from their "
                         "exports, without running the program functions")
    args = ap.parse_args(argv)
    config = EngineConfig(
        reduced=not args.full, batch=args.batch, store_dir=args.store_dir,
        max_len=512 if args.full else 128, device=args.device,
        group_prefill=args.group_prefill,
        paging=(PagingConfig(kv_block=args.kv_block,
                             arena_blocks=args.arena_blocks,
                             timeslice=args.timeslice)
                if args.paged or args.prefix else None),
        prefix=(PrefixConfig(max_suffix=args.prefix_max_suffix)
                if args.prefix else None),
        spec=(SpecConfig(k=args.spec_k, ngram=args.spec_ngram)
              if args.spec_k is not None else None),
        horizon=(HorizonConfig(length=args.horizon)
                 if args.horizon is not None and args.horizon >= 2
                 else None))
    eng = ServingEngine(args.arch, config)
    rng = np.random.default_rng(0)
    # with --prefix, every prompt starts with the same 16 tokens
    head = (rng.integers(0, eng.cfg.vocab_size, size=16) if args.prefix
            else np.zeros(0, np.int64))
    for _ in range(args.requests):
        eng.submit(np.concatenate(
            [head, rng.integers(0, eng.cfg.vocab_size, size=8)]),
            args.max_new)
    print(eng.run())
    print(eng.syscore.report()["programs"])
    if eng.syscore.store is not None:
        print(eng.syscore.store.report())
    if eng.paged:
        print(eng.pager.report())


if __name__ == "__main__":
    main()
