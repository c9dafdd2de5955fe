"""Serving step functions: the programs the Syscore hot-loads
(port of the serving part of ``repro/steps.py``, dense and paged
caches; every ported family shares it).

Each program works on the live cache tree in place and returns it, so the
engine's call sites read as the reference's: ``caches, out = prog(...)``.
Nothing in them waits for the host, so on the card the Syscore captures
each as a CUDA graph.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.syscore import ProgramSpec
from repro_torch.models import transformer


def _index(value, device) -> torch.Tensor:
    """A slot or a length as a (1,) int32 tensor on ``device`` (a tensor
    already there, as in a capture, is not copied)."""
    return torch.as_tensor(value, dtype=torch.int32,
                           device=device).reshape(1)


def make_prefill_slot_step(cfg, cache_len: int, ring: bool = True):
    """prefill_slot(params, caches, tokens (1,S), slot, length) ->
    (caches, last).

    Admission of ONE request into a live batch: prefill a fresh batch-1
    cache and copy its rows, and its ``pos``, into slot ``slot`` of the live
    tree.  Nothing outside row ``slot`` is touched, so the other slots keep
    decoding between executions.  ``last`` is the (V,) logits at the final
    valid prompt position.  ``slot`` and ``length`` are int32 scalars on
    the device, as in the reference (``.at[slot].set``, ``jnp.take``), or
    Python ints; the rows are written and read through device indices, so
    the program never reads them on the host.  ``ring=False`` matches the
    full-length windowed buffers of the speculative engine."""
    def prefill_slot(params, caches, tokens, slot, length):
        slot = _index(slot, tokens.device).long()
        length = _index(length, tokens.device)
        fresh = transformer.init_cache(cfg, 1, cache_len, ring=ring,
                                       device=tokens.device)
        logits, c1 = transformer.forward(
            cfg, params, tokens, mode="prefill", caches=fresh,
            lengths=length)
        caches["pos"].index_copy_(0, slot, c1["pos"])
        # group-stacked leaves carry a leading (layers,) axis: batch is axis
        # 1; tail leaves index batch at axis 0
        for name, group in caches["groups"].items():
            for leaf, buf in group.items():
                buf.index_copy_(1, slot, c1["groups"][name][leaf])
        for name, layer in caches["tail"].items():
            for leaf, buf in layer.items():
                buf.index_copy_(0, slot, c1["tail"][name][leaf])
        last = logits[0].index_select(0, (length - 1).long())[0]
        return caches, last

    return prefill_slot


def make_paged_prefill_slot_step(cfg, cache_len: int, kv_block: int):
    """Paged-arena admission program (repro_torch.core.paging).

    Same contract as :func:`make_prefill_slot_step`, but the live cache
    tree carries a physical-block KV arena and a per-slot block table
    instead of dense per-slot buffers: the fresh batch-1 prefill cache is
    computed exactly as in the dense path (so admission stays token-exact;
    windowed layers prefill a full-length buffer, so logical block j holds
    positions [j*bs, (j+1)*bs) for every kind), then its attention rows are
    copied, block by block, into the arena blocks the host-side pager
    mapped for this slot, while recurrent state rows go into the slot as
    before.  Unmapped table entries (-1, beyond the request's reservation)
    and read-only shared mappings (``-(p + 2)``) send their block to the
    arena's sink (``attention.write_paged_kv``), the port's form of the
    reference's out-of-range index under ``mode="drop"``."""
    n_blocks = cache_len // kv_block

    def to_arena(arena, full, dest, axis):
        blocks = full.reshape(*full.shape[:axis], n_blocks, kv_block,
                              *full.shape[axis + 1:])
        arena.index_copy_(axis, dest, blocks.to(arena.dtype))

    def prefill_slot(params, caches, tokens, slot, length):
        slot = _index(slot, tokens.device).long()
        length = _index(length, tokens.device)
        fresh = transformer.init_cache(cfg, 1, cache_len, ring=False,
                                       device=tokens.device)
        logits, c1 = transformer.forward(
            cfg, params, tokens, mode="prefill", caches=fresh,
            lengths=length)
        row = caches["block_table"].index_select(0, slot)[0]   # (n_blocks,)
        caches["pos"].index_copy_(0, slot, c1["pos"])
        # group-stacked leaves carry a leading (layers,) axis: the arena
        # and batch axes are 1 there; tail leaves use axis 0
        for top, axis in (("groups", 1), ("tail", 0)):
            for name, layer in caches[top].items():
                for leaf, buf in layer.items():
                    full = c1[top][name][leaf]
                    if leaf in ("k", "v"):
                        sink = buf.shape[axis] - 1
                        dest = torch.where(row >= 0, row,
                                           torch.full_like(row, sink))
                        to_arena(buf, full.select(axis, 0), dest.long(),
                                 axis)
                    else:
                        buf.index_copy_(axis, slot, full)
        last = logits[0].index_select(0, (length - 1).long())[0]
        return caches, last

    return prefill_slot


def make_serve_step(cfg):
    """decode(params, caches, token (B,1)) -> (caches, next (B,1), logits).

    One greedy decode step; each row reads its position from the per-slot
    ``pos`` in the cache tree and the tree comes back with it advanced."""
    def serve_step(params, caches, token):
        logits, caches = transformer.decode_step(cfg, params, caches, token)
        return caches, transformer.greedy_token(cfg, logits), logits

    return serve_step


def make_verify_step(cfg):
    """verify(params, caches, tokens (B, k+1)) -> (caches, ys (B, k+1),
    n_new (B,)).

    One execution scores each row's last accepted token and k drafts,
    accepts the longest greedy-matching prefix and leaves the cache rolled
    back to exactly the accepted state
    (:func:`~repro_torch.models.transformer.verify_decode`)."""
    def verify_step(params, caches, tokens):
        return transformer.verify_decode(cfg, params, caches, tokens)

    return verify_step


def make_decode_horizon_step(cfg, horizon: int, eos_id=None):
    """decode_horizon(params, caches, tokens (B, 1), budget (B,)) ->
    (caches, events).

    ``horizon`` greedy decode steps in one execution, with the greedy
    token fed back on the device and per-slot termination (EOS or an
    exhausted budget) masked there
    (:func:`~repro_torch.models.transformer.decode_horizon`); the host
    reads the event buffer back once per horizon."""
    def decode_horizon_step(params, caches, tokens, budget):
        return transformer.decode_horizon(cfg, params, caches, tokens,
                                          budget, horizon=horizon,
                                          eos_id=eos_id)

    return decode_horizon_step


def serve_program_specs(cfg, config, params, caches
                        ) -> Dict[str, ProgramSpec]:
    """The serving programs for an :class:`EngineConfig`, bound to the
    engine's ``params`` and ``caches``: ``prefill_slot`` (one admission
    into a live batch; its per-call inputs are the (1, prefill_len)
    tokens, the slot and the length) and ``decode`` (one greedy token for
    every slot; its input is the (batch, 1) tokens).  A paged config
    admits through :func:`make_paged_prefill_slot_step`; ``decode`` reads
    the block table from the tree.

    With ``config.spec`` a ``verify`` program scores ``spec.k`` drafts per
    slot in one execution (its input: the (batch, k+1) tokens), and a
    dense admission prefills flat windowed buffers (``ring=False``, as the
    engine's caches then are: rollback needs a rejected write at an
    absolute slot past the truncated ``pos``, never inside a live ring
    window).  With ``config.horizon`` a ``decode_horizon`` program runs
    ``horizon.length`` greedy steps in one execution (its inputs: the
    (batch, 1) tokens and the (batch,) budgets), with ``config.eos_id``
    as its in-graph EOS."""
    device = caches["pos"].device
    s = config.resolved_prefill_len
    prefill = (make_paged_prefill_slot_step(cfg, config.max_len,
                                            config.paging.kv_block)
               if config.paged else
               make_prefill_slot_step(cfg, config.max_len,
                                      ring=config.spec is None))

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    tokens = torch.zeros((1, s), dtype=torch.int32, device=device)
    token = torch.zeros((config.batch, 1), dtype=torch.int32, device=device)
    specs = {
        "prefill_slot": ProgramSpec(
            "prefill_slot", prefill,
            resident=(params, caches),
            inputs=(tokens, scalar(0), scalar(s))),
        "decode": ProgramSpec("decode", make_serve_step(cfg),
                              resident=(params, caches), inputs=(token,)),
    }
    if config.spec is not None:
        drafts = torch.zeros((config.batch, config.spec.k + 1),
                             dtype=torch.int32, device=device)
        specs["verify"] = ProgramSpec("verify", make_verify_step(cfg),
                                      resident=(params, caches),
                                      inputs=(drafts,))
    if config.horizon is not None:
        budget = torch.zeros((config.batch,), dtype=torch.int32,
                             device=device)
        specs["decode_horizon"] = ProgramSpec(
            "decode_horizon",
            make_decode_horizon_step(cfg, config.horizon.length,
                                     config.eos_id),
            resident=(params, caches), inputs=(token, budget))
    return specs
